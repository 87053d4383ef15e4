"""The two fused kernels of the subset-ELBO step, each with its plain PyTorch
version, its ``torch.autograd.Function`` and a launch counter; the forward,
weight and data gradients of the cnn models' float32 convolutions, each with
its plain version and a launch counter; and the cnn trunks' BatchNorm + swish,
likewise.

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
  * Logits are float32 or, under the ``bfloat16_full`` policy, bf16. The bf16
    logits take their own kernel (``bce_sum_bf16``, the same two passes and
    the same bit-identical reruns), which also replaces ``_bce_kernel`` /
    ``_bce_kernel_nomask`` (``_bce_pallas``, ``mmdyn_tpu/ops/kernels.py:247``)
    and does all its math in float32, as ``_bce_jnp`` upcasts inside its
    reduce. Target and mask are float32 under every policy.
  * The bf16 kernel is bound by bytes: 75.5 MB at K=4, B=512, P=12288, 22.5
    us at 3.35 TB/s. Loads in flight: each thread takes 8 consecutive
    columns and issues one 16-byte load of 8 bf16 logits per row (two of the
    target, two of the mask) before any arithmetic, where the f32 design's
    2-byte scalar loads made 64-byte warp requests. Instructions per logit:
    one ``ex2.approx`` for exp(-|x|) and one ``lg2.approx`` per 8K logits for
    the log of the product of their (1 + e) factors, 8 SASS instructions per
    logit where the accurate ``expf`` / ``log1pf`` took 55. The approximate
    intrinsics and the product add under 1e-7 per logit; the sums agree with
    the plain version's to a few 1e-7 relative. Rows that are not a multiple
    of 8 columns and views off 16-byte alignment take a scalar-load
    instantiation of the same kernel. K is at most ``MAX_SUBSETS``.

Both backward passes are the analytic formulas of the JAX custom VJPs
(``_bwd``, ``_bce_bwd``), written in torch ops, as the JAX package runs them
in XLA rather than Pallas.

``conv_wgrad_f32`` — the weight gradient of a float32 convolution with a 4 x 4
kernel, stride 1 or 2, padding 0 or 1 (every layer of ``models/vae.py``'s
``conv_trunk`` and ``Decoder.hallucinate``), summed over the batch.
  * Replaces no TPU kernel (XLA computes the JAX package's convolution
    gradients); CUDA source ``csrc/conv_wgrad.cu``. Added because the
    training step runs cuDNN's deterministic algorithms (bit-identical
    reruns), which leave float32 weight gradients to ``wgrad_alg1`` and FFT.
  * Bound by FFMA throughput: 2 * M * N * K operations for M = C_out,
    N = C_in * 16, K = batch * H_out * W_out, in float32 without tensor cores
    (67 TFLOP/s); 1.29 TFLOP a step of the dyn_modeling cell at 256 x 8.
  * Design: an implicit GEMM with split-K; each split writes its partial to a
    workspace and a second kernel sums the partials in a fixed order, so the
    sum is deterministic without atomics. The split count and the tile follow
    (M, N, K) alone (``conv_wgrad_f32_splits`` in the source).
  * ``models/layers.py`` calls it from the backward of the float32 ``Conv2d``
    and ``ConvTranspose2d``; a transposed convolution passes its output
    gradient as ``x`` and its input as ``dy``.

``conv_dgrad_f32`` — the data gradient of a float32 convolution of the same
geometry: the encoders' input gradients, and the decoders' transposed-
convolution forwards (a transposed convolution's forward is a convolution's
data gradient, its weight read as (C_in, C_out, 4, 4)).
  * Replaces no TPU kernel (XLA computes the JAX package's data gradients and
    transposed convolutions); CUDA source ``csrc/conv_dgrad.cu``. Added
    because under cuDNN's deterministic algorithms (bit-identical reruns)
    float32 data gradients run as ``dgrad2d_alg1_1`` and 32 x 32 FFTs, at
    12-24% of an H100's float32 rate: 115 ms of a 227 ms dyn_modeling step.
  * Bound by FFMA throughput: 2 * B * C_dy * H_dy * W_dy * C_x * 16
    operations in float32 without tensor cores (67 TFLOP/s); 1.28 TFLOP, 19.0
    ms, over the 14 calls of a dyn_modeling step at 256 x 8.
  * Design: stride 2 an implicit GEMM (M = C_x, N = the dX pixels, K = C_dy
    x taps) on a re-laid copy of the weight, split into its four sub-pixel
    phases, each with exactly its 2 x 2 taps; stride 1 (5 x 5 <-> 8 x 8) a
    GEMM of the weight as it is (M = C_x x 16 taps, N = whole images' dY
    pixels, K = C_dy) whose taps each dX pixel then adds from shared memory.
    No split-K and no atomics: each output is one thread's sum in a fixed
    order, so the bits depend on neither the batch nor the tile, which
    follows the shapes alone.
  * A custom operator (``mmdyn::conv_dgrad``) with a fake and autograd (the
    gradient to ``dy`` is the convolution's forward, ``conv_fprop_f32``, to
    the weight ``conv_wgrad_f32``), so that ``torch.export`` records it as one
    node and an exported artifact runs the kernel. ``models/layers.py`` calls
    it from the forward of the float32 ``ConvTranspose2d`` and the backward of
    the float32 ``Conv2d``.

``conv_fprop_f32`` — the forward of a float32 convolution of the same
geometry: the encoders' convolutions, and the decoders' transposed-
convolution data gradients (a transposed convolution's data gradient is a
convolution's forward of its output gradient, its weight read as (C_out,
C_in, 4, 4) of that convolution).
  * Replaces no TPU kernel (XLA computes the JAX package's convolutions);
    CUDA source ``csrc/conv_fprop.cu``. Added because cuDNN's float32 forward
    ran on FFMA: 33.1 ms of a 140 ms dyn_modeling step at 256 x 8.
  * Bound: the 16 calls of that step on the TF32 tensor cores, three
    products a term, 3.87 TFLOP, 7.8 ms at 495 TFLOP/s (their 1.29 TFLOP
    would take 19.2 ms on FFMA at 67 TFLOP/s).
  * Design: each operand split into a TF32 high part and a TF32 residual;
    hi*hi + hi*lo + lo*hi on ``wgmma`` into a fresh fragment for every 32
    terms of K, each added into a float32 accumulator with a rounded add, so
    the result is float32-accurate (the source's header). The weight is split
    once per call into a workspace laid out as the kernel's stages, the input
    gathered per tile with zero fill. No split-K and no atomics; the tile
    follows N alone, and every tile sums each output in the same order, so
    the bits depend on neither the batch nor the tile.
  * A custom operator (``mmdyn::conv_fprop``) with a fake and autograd (the
    gradient to x is ``conv_dgrad_f32``, to the weight ``conv_wgrad_f32``).
    ``models/layers.py`` calls it from the forward of the float32 ``Conv2d``
    and the backward of the float32 ``ConvTranspose2d``.

``fused_bn_swish`` — train-mode BatchNorm (statistics per (group, channel))
followed by swish on float32 activations, with its closed-form backward.
  * Replaces no TPU kernel (XLA fuses BatchNorm and swish into neighbouring
    passes in the JAX package); CUDA source ``csrc/bn_swish.cu``. Added
    because as separate PyTorch operations, differentiated op by op, they were
    about 11 passes over each element forward and 26 backward.
  * Bound by bytes: x read and y written forward, the gradient and x read and
    dx written backward; 21.33 GB a dyn_modeling step at 2,048 rows, 6.37 ms
    at 3.35 TB/s.
  * Design: the statistics in one read (each block's exact two-pass mean and
    M2, merged by Chan's formula in a fixed tree), y in one read-and-write
    pass; the backward (the JAX package's ``_train_bn_manual`` closed form
    with swish's derivative folded in) one read for the two sums a (group,
    channel) and one pass for dx, recomputing x_hat and the sigmoid from x
    and the saved mean and inv. No atomics; the grid follows the shapes.
  * The plain versions keep ``var_mean``'s statistics and the forward's
    operations of ``models/layers.py``'s composite, and write the same
    closed-form backward in torch operations.
  * A custom operator (``mmdyn::bn_swish``, its backward
    ``mmdyn::bn_swish_backward``), so that ``torch.export`` records it as one
    node.

Dispatch: a tensor on the CPU takes the plain version; a CUDA tensor launches
the kernel or raises. Each CUDA launch adds one to the wrapper's ``launches``;
a ``bce_sum`` launch on bf16 logits also to ``launches_bf16``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from mmdyn_tpu_torch.config import BN_EPS, POE_EPS
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


def _require_cuda(name: str, t: torch.Tensor, device,
                  dtypes=(torch.float32,)) -> None:
    names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
    _require(t.dtype in dtypes, f"{name}: {names} expected, got {t.dtype}")
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
        _require_cuda(name, t, mu.device)

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
    _require_cuda("logits", logits, logits.device, (torch.float32, torch.bfloat16))
    for name, t in (("target", target), ("mask", mask)):
        if t is not None:
            _require_cuda(name, t, logits.device)
    k = logits.shape[0]
    row = target.numel()
    bf16 = logits.dtype == torch.bfloat16
    _require(not bf16 or 1 <= k <= MAX_SUBSETS,
             f"bf16 logits: 1 to {MAX_SUBSETS} rows, got {k}")

    lib = build.load("bce_sum")
    n_partials = (lib.bce_sum_bf16_num_partials if bf16 else lib.bce_sum_num_partials)(row)
    scratch = torch.empty(n_partials + 1, device=logits.device,
                          dtype=torch.float32)
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    build.check((lib.bce_sum_bf16 if bf16 else lib.bce_sum_f32)(
        logits.data_ptr(), target.data_ptr(),
        None if mask is None else mask.data_ptr(),
        scratch.data_ptr(), scratch[n_partials:].data_ptr(), k, row, stream),
        "bce_sum launch")
    fused_masked_bce_sum.launches += 1
    fused_masked_bce_sum.launches_bf16 += bf16
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
    """Sum-reduced BCE-with-logits of (K, B, ...) float32 or bf16 logits
    against a shared float32 (B, ...) target, optionally masked by a
    (B, ...) ``mask`` that multiplies both sides (problems.py:409-411
    semantics); float32 math and result. The CUDA kernel for CUDA tensors,
    the plain version for CPU tensors; differentiable in logits, with the
    cotangent in the logits' dtype."""
    return _BceSum.apply(logits, target, mask)


fused_masked_bce_sum.launches = 0
fused_masked_bce_sum.launches_bf16 = 0     # those of them with bf16 logits


# ---------------------------------------------------------------------------
# forward, weight and data gradients of the float32 convolutions
# ---------------------------------------------------------------------------

CONV_TAPS = 4               # the kernels' height and width


def _square(name, v):
    """An int, or an (a, a) pair, as an int."""
    a, b = (v, v) if isinstance(v, int) else tuple(v)
    _require(a == b, f"{name}: the same on both axes expected, got {v}")
    return int(a)


def _check_conv_geometry(fn, kernel_size, stride, padding, dilation=1, groups=1):
    """(stride, padding) of a convolution that ``conv_fprop_f32``,
    ``conv_wgrad_f32`` and ``conv_dgrad_f32`` (named ``fn`` in the error)
    take: a 4 x 4 kernel, stride 1 or 2, padding 0 or 1, dilation 1, groups 1,
    the same on both axes; raises on any other."""
    k = _square("kernel_size", kernel_size)
    s, p = _square("stride", stride), _square("padding", padding)
    d = _square("dilation", dilation)
    _require(k == CONV_TAPS, f"{fn}: a {CONV_TAPS} x {CONV_TAPS} kernel only, got {k}")
    _require(s in (1, 2) and p in (0, 1),
             f"{fn}: stride 1 or 2 and padding 0 or 1 only, got {s}, {p}")
    _require(d == 1 and groups == 1,
             f"{fn}: dilation 1 and groups 1 only, got {d}, {groups}")
    return s, p


def conv_wgrad_plain(x, dy, stride, padding):
    """dW[m, c, kh, kw] = sum over (b, oh, ow) of dy[b, m, oh, ow] *
    x[b, c, oh * stride - padding + kh, ow * stride - padding + kw]: the
    kernel's implicit GEMM written out, each image's patches of x
    (``F.unfold``) against its dy in a matmul, summed over the batch in
    order, in the inputs' dtype."""
    b, c = x.shape[:2]
    m = dy.shape[1]
    cols = F.unfold(x, CONV_TAPS, padding=padding, stride=stride)    # (B, C*16, L)
    d = dy.reshape(b, m, -1)                                         # (B, M, L)
    dw = torch.zeros((m, cols.shape[1]), dtype=x.dtype, device=x.device)
    for i in range(b):
        dw.addmm_(d[i], cols[i].T)
    return dw.reshape(m, c, CONV_TAPS, CONV_TAPS)


def _conv_wgrad_cuda(x, dy, stride, padding):
    for name, t in (("x", x), ("dy", dy)):
        _require_cuda(name, t, x.device)
    b, c, h, w = x.shape
    m, ho, wo = dy.shape[1:]
    n, k = c * CONV_TAPS ** 2, b * ho * wo
    dw = torch.empty((m, c, CONV_TAPS, CONV_TAPS), device=x.device, dtype=torch.float32)
    if k == 0 or dw.numel() == 0:
        return dw.zero_()
    lib = build.load("conv_wgrad")
    splits = lib.conv_wgrad_f32_splits(m, n, k)
    # the kernel's offsets are 32-bit
    _require(max(x.numel(), dy.numel(), splits * m * n) < 2 ** 31,
             f"conv_wgrad_f32: x {tuple(x.shape)}, dy {tuple(dy.shape)} and a workspace "
             f"of {splits} x {m} x {n} must each hold under 2^31 elements")
    ws = torch.empty((splits, m, n), device=x.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(lib.conv_wgrad_f32(
        x.data_ptr(), dy.data_ptr(), ws.data_ptr(), dw.data_ptr(), b, c, h, w, m, ho, wo,
        stride, padding, splits, stream), "conv_wgrad launch")
    conv_wgrad_f32.launches += 1
    return dw


def conv_wgrad_f32(x, dy, kernel_size, stride, padding, dilation=1, groups=1):
    """The weight gradient (M, C, 4, 4) of the convolution of x (B, C, H, W)
    whose output gradient is dy (B, M, H_out, W_out), both NCHW contiguous:
    the CUDA kernel for float32 CUDA tensors, the plain version for CPU
    tensors. Raises outside ``_check_conv_geometry``'s geometry."""
    s, p = _check_conv_geometry("conv_wgrad_f32", kernel_size, stride, padding, dilation,
                                groups)
    _require(x.dim() == 4 and dy.dim() == 4 and x.shape[0] == dy.shape[0],
             f"x (B, C, H, W) and dy (B, M, H_out, W_out) expected, got "
             f"{tuple(x.shape)} and {tuple(dy.shape)}")
    out = tuple((size + 2 * p - CONV_TAPS) // s + 1 for size in x.shape[2:])
    _require(tuple(dy.shape[2:]) == out,
             f"dy: spatial {out} expected for x {tuple(x.shape)}, got {tuple(dy.shape)}")
    _require(x.is_contiguous() and dy.is_contiguous(), "x and dy must be contiguous")
    if _on_cpu(x):
        return conv_wgrad_plain(x, dy, s, p)
    return _conv_wgrad_cuda(x, dy, s, p)


conv_wgrad_f32.launches = 0


def conv_dgrad_plain(dy, weight, input_size, stride, padding):
    """dX[b, c, ih, iw] = sum over (m, kh, kw) of dy[b, m, oh, ow] *
    weight[m, c, kh, kw], ih = oh * stride - padding + kh (likewise iw): the
    kernel's GEMM over channels written out as one matmul of each image's
    dy with the weight, then its taps summed into place (``F.fold``), in the
    inputs' dtype. ``input_size`` is dX's (H, W)."""
    b, m = dy.shape[:2]
    c = weight.shape[1]
    w_t = weight.reshape(m, c * CONV_TAPS ** 2).T.contiguous()     # (C*16, M)
    cols = torch.matmul(w_t, dy.reshape(b, m, -1))                   # (B, C*16, L)
    return F.fold(cols, tuple(input_size), CONV_TAPS, padding=padding, stride=stride)


def _conv_dgrad_cuda(dy, weight, input_size, stride, padding):
    for name, t in (("dy", dy), ("weight", weight)):
        _require_cuda(name, t, dy.device)
    b, m, ho, wo = dy.shape
    c = weight.shape[1]
    h, w = input_size
    dx = torch.empty((b, c, h, w), device=dy.device, dtype=torch.float32)
    if dx.numel() == 0 or m == 0:
        return dx.zero_()
    lib = build.load("conv_dgrad")
    floats = lib.conv_dgrad_f32_workspace(m, c, stride, ho, wo)
    # the kernel's offsets are 32-bit
    _require(max(dy.numel(), dx.numel(), floats) < 2 ** 31,
             f"conv_dgrad_f32: dy {tuple(dy.shape)}, dx {tuple(dx.shape)} and the weight's "
             f"copy must each hold under 2^31 elements")
    wt = torch.empty(floats, device=dy.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(dy.device).cuda_stream
    build.check(lib.conv_dgrad_f32(
        dy.data_ptr(), weight.data_ptr(), wt.data_ptr(), dx.data_ptr(), b, m, ho, wo, c, h, w,
        stride, padding, stream), "conv_dgrad launch")
    conv_dgrad_f32.launches += 1
    return dx


@torch.library.custom_op("mmdyn::conv_dgrad", mutates_args=())
def _conv_dgrad_op(dy: torch.Tensor, weight: torch.Tensor, input_size: list[int],
                   stride: int, padding: int) -> torch.Tensor:
    """dX (B, C, *input_size) from dy (B, M, H_out, W_out) and the weight
    (M, C, 4, 4)."""
    fn = conv_dgrad_plain if _on_cpu(dy) else _conv_dgrad_cuda
    return fn(dy.contiguous(), weight.contiguous(), input_size, stride, padding)


@_conv_dgrad_op.register_fake
def _(dy, weight, input_size, stride, padding):
    return dy.new_empty((dy.shape[0], weight.shape[1], *input_size))


def _conv_dgrad_setup(ctx, inputs, output):
    dy, weight, _, stride, padding = inputs
    ctx.save_for_backward(dy, weight)
    ctx.geometry = (stride, padding)


def _conv_dgrad_grad(ctx, g):
    """The data gradient is linear in dy and in the weight: its gradient to dy
    is the convolution's forward of ``g`` (``conv_fprop_f32``), to the weight
    the convolution's weight gradient with ``g`` as the input and dy as the
    output's gradient."""
    dy, weight = ctx.saved_tensors
    s, p = ctx.geometry
    ddy = conv_fprop_f32(g, weight, s, p) if ctx.needs_input_grad[0] else None
    dw = (conv_wgrad_f32(g.contiguous(), dy.contiguous(), CONV_TAPS, s, p)
          if ctx.needs_input_grad[1] else None)
    return ddy, dw, None, None, None


_conv_dgrad_op.register_autograd(_conv_dgrad_grad, setup_context=_conv_dgrad_setup)


def conv_dgrad_f32(dy, weight, input_size, stride, padding, dilation=1, groups=1):
    """The data gradient dX (B, C, H, W), ``input_size`` = (H, W), of the
    convolution of weight (M, C, 4, 4) whose output gradient is dy (B, M,
    H_out, W_out); equally the forward of the transposed convolution of dy
    by that weight (read as (C_in, C_out, 4, 4)) at output size (H, W). The
    CUDA kernel for float32 CUDA tensors, the plain version for CPU tensors,
    through the custom operator ``mmdyn::conv_dgrad``; differentiable in dy
    and the weight. Raises outside ``_check_conv_geometry``'s geometry."""
    s, p = _check_conv_geometry("conv_dgrad_f32", weight.shape[2:], stride, padding,
                                dilation, groups)
    size = [int(v) for v in input_size]
    _require(dy.dim() == 4 and weight.dim() == 4 and dy.shape[1] == weight.shape[0]
             and len(size) == 2,
             f"dy (B, M, H_out, W_out), weight (M, C, 4, 4) and input_size (H, W) expected, "
             f"got {tuple(dy.shape)}, {tuple(weight.shape)} and {tuple(size)}")
    out = tuple((v + 2 * p - CONV_TAPS) // s + 1 for v in size)
    _require(tuple(dy.shape[2:]) == out,
             f"dy: spatial {out} expected for input size {tuple(size)}, got {tuple(dy.shape)}")
    return _conv_dgrad_op(dy, weight, size, s, p)


conv_dgrad_f32.launches = 0


def conv_fprop_plain(x, weight, stride, padding):
    """Y[b, n, oh, ow] = sum over (c, kh, kw) of weight[n, c, kh, kw] *
    x[b, c, oh * stride - padding + kh, ow * stride - padding + kw], as torch
    computes it (``F.conv2d``, oneDNN's on the CPU), in the inputs' dtype. The
    kernel's sum, three TF32 products a term, has no counterpart in plain
    operations; the CPU's own convolution keeps the CPU paths' numbers and
    speed where they were."""
    return F.conv2d(x, weight, None, stride, padding)


def _conv_fprop_cuda(x, weight, stride, padding):
    for name, t in (("x", x), ("weight", weight)):
        _require_cuda(name, t, x.device)
    b, c, h, w = x.shape
    n = weight.shape[0]
    ho, wo = ((v + 2 * padding - CONV_TAPS) // stride + 1 for v in (h, w))
    y = torch.empty((b, n, ho, wo), device=x.device, dtype=torch.float32)
    if y.numel() == 0 or c == 0:
        return y.zero_()
    # the kernel's offsets into x and y are 32-bit
    _require(max(x.numel(), y.numel()) < 2 ** 31,
             f"conv_fprop_f32: x {tuple(x.shape)} and y {tuple(y.shape)} must each hold "
             f"under 2^31 elements")
    lib = build.load("conv_fprop")
    # the weight's TF32 hi and lo parts, laid out for the kernel's tile
    ws = torch.empty(lib.conv_fprop_f32_workspace(n, c * CONV_TAPS ** 2),
                     device=x.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(lib.conv_fprop_f32(
        x.data_ptr(), weight.data_ptr(), ws.data_ptr(), y.data_ptr(), b, c, h, w, n, ho, wo,
        stride, padding, stream), "conv_fprop launch")
    conv_fprop_f32.launches += 1
    return y


@torch.library.custom_op("mmdyn::conv_fprop", mutates_args=())
def _conv_fprop_op(x: torch.Tensor, weight: torch.Tensor, stride: int,
                   padding: int) -> torch.Tensor:
    """Y (B, N, H_out, W_out) from x (B, C, H, W) and the weight (N, C, 4,
    4)."""
    fn = conv_fprop_plain if _on_cpu(x) else _conv_fprop_cuda
    return fn(x.contiguous(), weight.contiguous(), stride, padding)


@_conv_fprop_op.register_fake
def _(x, weight, stride, padding):
    out = [(v + 2 * padding - CONV_TAPS) // stride + 1 for v in x.shape[2:]]
    return x.new_empty((x.shape[0], weight.shape[0], *out))


def _conv_fprop_setup(ctx, inputs, output):
    x, weight, stride, padding = inputs
    ctx.save_for_backward(x, weight)
    ctx.geometry = (stride, padding)


def _conv_fprop_grad(ctx, g):
    """The convolution's data gradient (``conv_dgrad_f32``) and weight
    gradient (``conv_wgrad_f32``) of ``g``."""
    x, weight = ctx.saved_tensors
    s, p = ctx.geometry
    g = g.contiguous()
    dx = (conv_dgrad_f32(g, weight, x.shape[2:], s, p)
          if ctx.needs_input_grad[0] else None)
    dw = conv_wgrad_f32(x, g, CONV_TAPS, s, p) if ctx.needs_input_grad[1] else None
    return dx, dw, None, None


_conv_fprop_op.register_autograd(_conv_fprop_grad, setup_context=_conv_fprop_setup)


def conv_fprop_f32(x, weight, stride, padding, dilation=1, groups=1):
    """The forward Y (B, N, H_out, W_out) of the convolution of x (B, C, H, W)
    by weight (N, C, 4, 4), without bias; equally the data gradient of the
    transposed convolution whose weight is ``weight`` (read as (C_in, C_out,
    4, 4)) and whose output gradient is x. The CUDA kernel (TF32 tensor
    cores, three products a term, float32 sums) for float32 CUDA tensors,
    the plain version for CPU tensors, through the custom operator
    ``mmdyn::conv_fprop``; differentiable in x and the weight. Raises outside
    ``_check_conv_geometry``'s geometry."""
    s, p = _check_conv_geometry("conv_fprop_f32", weight.shape[2:], stride, padding,
                                dilation, groups)
    _require(x.dim() == 4 and weight.dim() == 4 and x.shape[1] == weight.shape[1],
             f"x (B, C, H, W) and weight (N, C, 4, 4) expected, got {tuple(x.shape)} and "
             f"{tuple(weight.shape)}")
    _require(all(v + 2 * p >= CONV_TAPS for v in x.shape[2:]),
             f"x: spatial {tuple(x.shape[2:])} smaller than the kernel at padding {p}")
    return _conv_fprop_op(x, weight, s, p)


conv_fprop_f32.launches = 0


# ---------------------------------------------------------------------------
# train-mode BatchNorm + swish
# ---------------------------------------------------------------------------

def _grouped(t, groups):
    """(G*N, C, ...) -> (G, N, C, H*W), a view."""
    n, c = t.shape[:2]
    return t.reshape(groups, n // groups, c, -1)


def bn_swish_plain(x, weight, bias, groups=1, eps=BN_EPS):
    """(y, mean, var, inv) of BatchNorm + swish of x (G*N, C, ...), the
    statistics (G, C) biased, per (group, channel): ``var_mean`` and the
    operations of ``models/layers.py``'s ``train_batch_norm`` then ``swish``,
    in x's dtype."""
    c = x.shape[1]
    xg = _grouped(x, groups)
    var, mean = torch.var_mean(xg, dim=(1, 3), correction=0, keepdim=True)
    inv = torch.rsqrt(var + eps)
    u = (xg - mean) * (inv * weight.reshape(1, 1, c, 1)) + bias.reshape(1, 1, c, 1)
    y = u * torch.sigmoid(u)
    return (y.reshape(x.shape), mean.reshape(groups, c), var.reshape(groups, c),
            inv.reshape(groups, c))


def bn_swish_backward_plain(gy, x, weight, bias, mean, inv, groups=1):
    """(dx, dweight, dbias) of BatchNorm + swish from the output's gradient
    ``gy``, x and the forward's (G, C) mean and inv: with ct the gradient at
    swish's input, the closed form of the JAX package's ``_train_bn_manual``,
    dx = weight * inv / M * (M * ct - sum(ct) - x_hat * sum(ct * x_hat))
    over the M elements of each (group, channel)."""
    c = x.shape[1]
    xg, gg = _grouped(x, groups), _grouped(gy, groups)
    mean, inv = mean.reshape(groups, 1, c, 1), inv.reshape(groups, 1, c, 1)
    w, b = weight.reshape(1, 1, c, 1), bias.reshape(1, 1, c, 1)
    xc = xg - mean
    x_hat = xc * inv
    u = xc * (inv * w) + b
    s = torch.sigmoid(u)
    ct = gg * s * (1 + u * (1 - s))
    m = xg.shape[1] * xg.shape[3]
    sum_ct = ct.sum(dim=(1, 3), keepdim=True)
    sum_ctx = (ct * x_hat).sum(dim=(1, 3), keepdim=True)
    dx = (w * inv / m) * (m * ct - sum_ct - x_hat * sum_ctx)
    return dx.reshape(x.shape), sum_ctx.sum(dim=0).reshape(c), sum_ct.sum(dim=0).reshape(c)


def _bn_swish_shape(x, weight, bias, groups):
    """(rows a group, C, H * W) of x (G*N, C, ...), checked."""
    _require(x.dim() >= 2, f"x: (G*N, C, ...) expected, got {tuple(x.shape)}")
    n, c = x.shape[:2]
    _require(groups >= 1 and n % groups == 0, f"batch {n} does not split into {groups} groups")
    _require(tuple(weight.shape) == (c,) and tuple(bias.shape) == (c,),
             f"weight and bias: ({c},) expected, got {tuple(weight.shape)}, "
             f"{tuple(bias.shape)}")
    return n // groups, c, math.prod(x.shape[2:])


def _check_bn_swish_cuda(x, groups, c):
    _require(0 < x.numel() < 2 ** 31, f"bn_swish: 1 to 2^31 - 1 elements, got {x.numel()}")
    _require(groups * c < 65536, f"bn_swish: under 65,536 (group, channel) pairs, got "
             f"{groups * c}")


def _bn_swish_cuda(x, weight, bias, groups, eps):
    n, c, hw = _bn_swish_shape(x, weight, bias, groups)
    for name, t in (("x", x), ("weight", weight), ("bias", bias)):
        _require_cuda(name, t, x.device)
    _check_bn_swish_cuda(x, groups, c)
    lib = build.load("bn_swish")
    y = torch.empty_like(x)
    mean, var, inv = (torch.empty((groups, c), device=x.device, dtype=torch.float32)
                      for _ in range(3))
    ws = torch.empty(2 * groups * c * lib.bn_swish_pieces(n, hw), device=x.device,
                     dtype=torch.float32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(lib.bn_swish_forward(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(), mean.data_ptr(),
        var.data_ptr(), inv.data_ptr(), ws.data_ptr(), groups, n, c, hw, eps,
        stream), "bn_swish forward launch")
    fused_bn_swish.launches += 1
    return y, mean, var, inv


def _bn_swish_backward_cuda(gy, x, weight, bias, mean, inv, groups):
    n, c, hw = _bn_swish_shape(x, weight, bias, groups)
    for name, t in (("grad", gy), ("x", x), ("mean", mean), ("inv", inv)):
        _require_cuda(name, t, x.device)
    _require(gy.shape == x.shape, "grad: must match x")
    _check_bn_swish_cuda(x, groups, c)
    lib = build.load("bn_swish")
    dx = torch.empty_like(x)
    dw, db = (torch.empty(c, device=x.device, dtype=torch.float32) for _ in range(2))
    ws = torch.empty(2 * groups * c * lib.bn_swish_pieces(n, hw), device=x.device,
                     dtype=torch.float32)
    sums = torch.empty((2, groups, c), device=x.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(lib.bn_swish_backward(
        gy.data_ptr(), x.data_ptr(), weight.data_ptr(), bias.data_ptr(), mean.data_ptr(),
        inv.data_ptr(), dx.data_ptr(), dw.data_ptr(), db.data_ptr(), ws.data_ptr(),
        sums.data_ptr(), groups, n, c, hw, stream), "bn_swish backward launch")
    return dx, dw, db


# Custom operators, so that ``torch.export`` and ``torch.compile`` record each
# call as one opaque node (their fake versions give the shapes) where they
# could not trace the ctypes launch; autograd calls the backward operator.
@torch.library.custom_op("mmdyn::bn_swish", mutates_args=())
def _bn_swish_op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
                 eps: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """y and the (G, C) mean and inv that the backward takes."""
    fwd = bn_swish_plain if _on_cpu(x) else _bn_swish_cuda
    y, mean, _, inv = fwd(x, weight, bias, groups, eps)
    return y, mean, inv


@_bn_swish_op.register_fake
def _(x, weight, bias, groups, eps):
    _bn_swish_shape(x, weight, bias, groups)
    return (torch.empty_like(x), x.new_empty((groups, x.shape[1])),
            x.new_empty((groups, x.shape[1])))


@torch.library.custom_op("mmdyn::bn_swish_backward", mutates_args=())
def _bn_swish_backward_op(gy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor,
                          groups: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dweight, dbias) from the output's gradient."""
    bwd = bn_swish_backward_plain if _on_cpu(x) else _bn_swish_backward_cuda
    return bwd(gy.contiguous(), x, weight, bias, mean, inv, groups)


@_bn_swish_backward_op.register_fake
def _(gy, x, weight, bias, mean, inv, groups):
    return torch.empty_like(x), torch.empty_like(weight), torch.empty_like(bias)


def _bn_swish_setup(ctx, inputs, output):
    x, weight, bias, groups, _ = inputs
    _, mean, inv = output
    ctx.save_for_backward(x, weight, bias, mean, inv)
    ctx.groups = groups


def _bn_swish_grad(ctx, gy, _gmean, _ginv):
    dx, dw, db = _bn_swish_backward_op(gy, *ctx.saved_tensors, ctx.groups)
    return dx, dw, db, None, None


_bn_swish_op.register_autograd(_bn_swish_grad, setup_context=_bn_swish_setup)


def fused_bn_swish(x, weight, bias, groups=1, eps=BN_EPS):
    """swish(BatchNorm(x)) of x (G*N, C, ...) with batch statistics per
    (group, channel), the biased variance and ``eps``, affine by the (C,)
    ``weight`` and ``bias``. The CUDA kernel for float32 CUDA tensors
    (contiguous), the plain version for CPU tensors; differentiable in x,
    weight and bias."""
    return _bn_swish_op(x, weight, bias, groups, eps)[0]


fused_bn_swish.launches = 0
