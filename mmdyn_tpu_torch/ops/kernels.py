"""The two fused kernels of the subset-ELBO step, each with its plain PyTorch
version, its ``torch.autograd.Function`` and a launch counter.

``fused_poe_reparam`` — product-of-experts posterior of all K modality subsets
plus the reparameterised sample, in one pass.
  * Replaces ``_poe_kernel`` (``mmdyn_tpu/ops/kernels.py:86``, launched by
    ``_poe_reparam_pallas``); CUDA source ``csrc/poe_reparam.cu``.
  * Bound by memory bytes on paper: (2M + K) floats read and 3K written per
    (b, d) element; at the flagship's M=4, K=7, B=512, D=256 that is 18.9 MB,
    5.6 us at the H100's 3.35 TB/s.
  * Design: the TPU kernel casts the M-contraction as a (K, M) x (M, Bt*D)
    MXU matmul. With M <= 4 and K <= 7 the contraction belongs in registers.
    The flagship shape is one wave of the card, so the kernel is one chain of
    latencies (loads, 18 IEEE divisions and 18 log / exp per element,
    stores): one thread per element gives the most warps to hide them; M and
    K are template parameters, so the subsets are straight-line code; every
    load, the mask's included (read-only path, no shared-memory prologue),
    is issued before any arithmetic. Any ``B * D`` and any offset view take
    the same path.

``fused_masked_bce_sum`` — sum-reduced BCE-with-logits of (K, B, ...) logits
against a (B, ...) target shared over K, optionally masked.
  * Replaces ``_bce_kernel`` / ``_bce_kernel_nomask`` / ``_bce_pallas`` in
    ``mmdyn_tpu/ops/kernels.py``; CUDA source ``csrc/bce_sum.cu``.
  * Bound by memory bytes: the K*B*P logits and the B*P target (and mask) read
    once; at K=4, B=512, P=12288 that is 125.8 MB, 37.6 us at 3.35 TB/s.
  * Design: the TPU kernel carries its sum across a sequential grid. GPU
    blocks run in no order, so each block writes a partial (warp shuffles,
    then shared memory) and a second one-block pass sums the partials in a
    fixed order: no float atomics, the same bits on every run. Each thread
    reads target[j] once for all K logits of column j, so the target is never
    broadcast.

Both backward passes are the analytic formulas of the JAX custom VJPs
(``_bwd``, ``_bce_bwd``), written in torch ops, as the JAX package runs them
in XLA rather than Pallas.

Dispatch: a tensor on the CPU takes the plain version; a CUDA tensor launches
the kernel or raises. Each CUDA launch adds one to the wrapper's ``launches``.
"""

from __future__ import annotations

import torch

from mmdyn_tpu_torch.config import POE_EPS
from mmdyn_tpu_torch.ops import build

MAX_EXPERTS = 4
MAX_SUBSETS = 7


def _on_cpu(t: torch.Tensor) -> bool:
    """True for the plain path; False for the kernel; raises otherwise."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _require_cuda_f32(name: str, t: torch.Tensor, device) -> None:
    _require(t.dtype == torch.float32, f"{name}: float32 expected, got {t.dtype}")
    _require(t.device == device, f"{name}: on {t.device}, expected {device}")
    _require(t.is_contiguous(), f"{name}: must be contiguous")


# ---------------------------------------------------------------------------
# product of experts + reparameterisation
# ---------------------------------------------------------------------------

def poe_reparam_plain(mu, logvar, mask, noise, eps=POE_EPS):
    """mu/logvar: (M, B, D); mask: (K, M); noise: (K, B, D).

    Returns (z, pd_mu, pd_logvar), each (K, B, D). Port of
    ``_poe_reparam_jnp``, including the double epsilon.
    """
    var = torch.exp(logvar) + eps
    t = 1.0 / (var + eps)
    m_, b, d = mu.shape
    k = mask.shape[0]
    s = (mask @ t.reshape(m_, b * d)).reshape(k, b, d)
    a = (mask @ (mu * t).reshape(m_, b * d)).reshape(k, b, d)
    pd_mu = a / s
    pd_lv = torch.log(1.0 / s + eps)
    z = pd_mu + noise * torch.exp(0.5 * pd_lv)
    return z, pd_mu, pd_lv


def _poe_reparam_cuda(mu, logvar, mask, noise):
    _require(mu.dim() == 3, f"mu: (M, B, D) expected, got {tuple(mu.shape)}")
    m_, b, d = mu.shape
    _require(mask.dim() == 2 and mask.shape[1] == m_,
             f"mask: (K, {m_}) expected, got {tuple(mask.shape)}")
    k = mask.shape[0]
    _require(1 <= m_ <= MAX_EXPERTS, f"at most {MAX_EXPERTS} experts, got {m_}")
    _require(1 <= k <= MAX_SUBSETS, f"at most {MAX_SUBSETS} subsets, got {k}")
    _require(logvar.shape == mu.shape, "logvar: must match mu")
    _require(noise.shape == (k, b, d), f"noise: {(k, b, d)} expected")
    for name, t in (("mu", mu), ("logvar", logvar), ("mask", mask),
                    ("noise", noise)):
        _require_cuda_f32(name, t, mu.device)

    z, pd_mu, pd_lv = (torch.empty((k, b, d), device=mu.device,
                                   dtype=torch.float32) for _ in range(3))
    if b * d == 0:              # no elements: nothing to build or launch
        return z, pd_mu, pd_lv
    lib = build.load("poe_reparam")
    stream = torch.cuda.current_stream(mu.device).cuda_stream
    build.check(lib.poe_reparam_f32(
        mu.data_ptr(), logvar.data_ptr(), mask.data_ptr(), noise.data_ptr(),
        z.data_ptr(), pd_mu.data_ptr(), pd_lv.data_ptr(), m_, k, b * d,
        POE_EPS, stream), "poe_reparam launch")
    fused_poe_reparam.launches += 1
    return z, pd_mu, pd_lv


class _PoeReparam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mu, logvar, mask, noise):
        if _on_cpu(mu):
            z, pd_mu, pd_lv = poe_reparam_plain(mu, logvar, mask, noise)
        else:
            z, pd_mu, pd_lv = _poe_reparam_cuda(mu, logvar, mask, noise)
        ctx.save_for_backward(mu, logvar, mask, noise, pd_mu, pd_lv)
        return z, pd_mu, pd_lv

    @staticmethod
    def backward(ctx, dz, dpdmu_up, dpdlv_up):
        """Port of ``_bwd`` (derivation in mmdyn_tpu/ops/kernels.py:16-28)."""
        eps = POE_EPS
        mu, logvar, mask, noise, pd_mu, pd_lv = ctx.saved_tensors
        m_, b, d = mu.shape
        k = mask.shape[0]
        var = torch.exp(logvar) + eps
        t_all = 1.0 / (var + eps)
        s = (mask @ t_all.reshape(m_, b * d)).reshape(k, b, d)

        dpd_mu = dz + dpdmu_up
        dpd_lv = 0.5 * dz * noise * torch.exp(0.5 * pd_lv) + dpdlv_up
        ds = -dpd_mu * pd_mu / s - dpd_lv / (s + eps * torch.square(s))
        w = (dpd_mu / s).reshape(k, b * d)
        sum_w = (mask.T @ w).reshape(m_, b, d)      # sum_k mask * dpd_mu / S
        sum_ds = (mask.T @ ds.reshape(k, b * d)).reshape(m_, b, d)
        dmu = sum_w * t_all
        dlv = (sum_w * mu + sum_ds) * (-t_all / (var + eps)) * torch.exp(logvar)
        return dmu, dlv, None, None


def fused_poe_reparam(mu, logvar, mask, noise):
    """(M, B, D) experts + (K, M) subset mask + (K, B, D) noise ->
    (z, pd_mu, pd_logvar), each (K, B, D). The CUDA kernel for CUDA tensors,
    the plain version for CPU tensors; differentiable in mu and logvar."""
    return _PoeReparam.apply(mu, logvar, mask, noise)


fused_poe_reparam.launches = 0


# ---------------------------------------------------------------------------
# masked BCE-with-logits + sum
# ---------------------------------------------------------------------------

def bce_sum_plain(logits, target, mask):
    """Port of ``_bce_jnp``, the K-sum form: sum_k BCE(x_k, z) is split into a
    target-free part and one z * (sum_k x_k) contraction, so the target is
    never broadcast over K."""
    x = logits.float()
    if mask is not None:
        x = x * mask[None]
    target_free = torch.sum(torch.clamp_min(x, 0.0)
                            + torch.log1p(torch.exp(-torch.abs(x))))
    z = target if mask is None else target * mask
    return target_free - torch.sum(z * torch.sum(x, dim=0))


def _bce_sum_cuda(logits, target, mask):
    _require(logits.dim() >= 2 and tuple(logits.shape[1:]) == tuple(target.shape),
             f"logits (K, *target.shape) expected, got {tuple(logits.shape)} "
             f"and target {tuple(target.shape)}")
    _require(mask is None or mask.shape == target.shape, "mask: must match target")
    for name, t in (("logits", logits), ("target", target), ("mask", mask)):
        if t is not None:
            _require_cuda_f32(name, t, logits.device)
    k = logits.shape[0]
    row = target.numel()

    lib = build.load("bce_sum")
    n_partials = lib.bce_sum_num_partials(row)
    scratch = torch.empty(n_partials + 1, device=logits.device,
                          dtype=torch.float32)
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    build.check(lib.bce_sum_f32(
        logits.data_ptr(), target.data_ptr(),
        None if mask is None else mask.data_ptr(),
        scratch.data_ptr(), scratch[n_partials:].data_ptr(), k, row, stream),
        "bce_sum launch")
    fused_masked_bce_sum.launches += 1
    return scratch[n_partials]


class _BceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, target, mask):
        if _on_cpu(logits):
            out = bce_sum_plain(logits, target, mask)
        else:
            out = _bce_sum_cuda(logits, target, mask)
        ctx.save_for_backward(logits, target, mask)
        return out

    @staticmethod
    def backward(ctx, g):
        """Port of ``_bce_bwd``: dlogits = g * m * (sigmoid(x) - z)."""
        logits, target, mask = ctx.saved_tensors
        x = logits.float()
        if mask is None:
            z = target[None]
        else:
            x = x * mask[None]
            z = (target * mask)[None]
        d = g * (torch.sigmoid(x) - z)
        if mask is not None:
            d = d * mask[None]
        return d.to(logits.dtype), None, None


def fused_masked_bce_sum(logits, target, mask=None):
    """Sum-reduced BCE-with-logits of (K, B, ...) logits against a shared
    (B, ...) target, optionally masked by a (B, ...) ``mask`` that multiplies
    both sides (problems.py:409-411 semantics). The CUDA kernel for CUDA
    tensors, the plain version for CPU tensors; differentiable in logits."""
    return _BceSum.apply(logits, target, mask)


fused_masked_bce_sum.launches = 0
