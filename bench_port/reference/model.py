"""The plain reference of the benchmark: the cnn-mvae over visual + tactile +
pose in plain PyTorch, float32, with no kernel, fusion or batching of the
program under test, and importing nothing of it.

A frozen copy of the architecture of ``mmdyn_tpu_torch/tools/gold.py``
(lines 1-200: ``GoldEncoder``, ``GoldDecoder``, ``GoldPoseEncoder``,
``GoldPoseDecoder``, ``gold_poe``), itself the copy of the paper's
reference (mmdyn/pytorch/models/vae.py:179-301). The modules are named as
the reference's ``state_dict`` names them, which the program's models
share, so one set of weights loads into both.

What differs from the golden model, and why:

* The loss is the subset ELBO as the JAX package and the program define it
  (``mmdyn_tpu/problems/reconstruction.py``): each encoder runs once (its
  BatchNorm statistics and dropout mask shared by every subset), the
  (K, B, D) reparameterisation noise is drawn once, and each image decoder
  runs once per scored subset with that subset's own BatchNorm statistics.
  The golden model runs the whole model once per subset instead, which
  draws other noise. Here the decoders are simply called once per subset.
* Dropout keeps a unit where ``u < 1 - rate`` (flax's rule, which the
  program follows); the golden model keeps ``u >= rate``.
* Draws come from a ``torch.Generator`` in the order the program's step
  makes them: the visual dropout mask (B, 512), the tactile one, then the
  (K, B, D) noise.
* ``precision`` rounds the operands of every convolution and matmul:
  ``float32`` (none: the reference), ``tf32`` (10 mantissa bits, what the
  tensor cores' TF32 mode keeps) or ``fp8`` (e4m3 with a per-tensor
  scale), which like ``bfloat16_full`` also keeps every activation in its
  precision: the output of each layer, BatchNorm and swish. The lower two
  make the control of ``correct``.

Everything runs with TF32 off (``strict_float32``).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

DROPOUT_RATE = 0.1          # vae.py:207
POE_EPS = 1e-8              # vae.py:311
BN_EPS = 1e-5
BOTTLENECK = (256, 5, 5)
PRECISIONS = ("float32", "tf32", "fp8")
FP8_MAX = 448.0             # the largest float8_e4m3fn

# (prior, visual, tactile, pose) experts of each subset, in the reference's
# pass order (problems.py:478-529), and the subsets each term scores
SUBSETS_POSE = ((1, 1, 1, 0), (1, 1, 0, 0), (1, 0, 1, 0), (1, 1, 1, 1),
                (1, 1, 0, 1), (1, 0, 1, 1), (1, 0, 0, 1))
VIS_SUBSETS = (0, 1, 3, 4)
TAC_SUBSETS = (0, 2, 3, 5)
POSE_SUBSETS = (3, 4, 5, 6)


@contextlib.contextmanager
def strict_float32():
    """float32 convolutions and matmuls without TF32, restored after."""
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


def round_operand(x, precision):
    """``x`` rounded to ``precision`` and returned as float32."""
    if precision == "float32":
        return x
    if precision == "tf32":
        # round to nearest on the 13 dropped mantissa bits
        bits = x.contiguous().view(torch.int32)
        bits = (bits + 0x1000) & ~0x1FFF
        return bits.view(torch.float32)
    if precision == "fp8":
        scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    raise ValueError(f"precision {precision!r} is not one of {PRECISIONS}")


class _Rounded(torch.autograd.Function):
    """Rounds in the forward; passes the gradient through unchanged."""

    @staticmethod
    def forward(ctx, x, precision):
        return round_operand(x, precision)

    @staticmethod
    def backward(ctx, g):
        return g, None


def rounded(x, precision):
    return x if precision == "float32" else _Rounded.apply(x, precision)


class _Op(nn.Module):
    """A layer whose operands, and under ``fp8`` whose output, take the
    model's precision (``precision`` is set on every layer by
    ``set_precision``)."""

    precision = "float32"

    def out(self, y):
        return rounded(y, "fp8") if self.precision == "fp8" else y


class Swish(_Op):
    def forward(self, x):
        return self.out(x * torch.sigmoid(x))


class Linear(nn.Linear, _Op):
    def forward(self, x):
        return self.out(F.linear(rounded(x, self.precision),
                                 rounded(self.weight, self.precision), self.bias))


class Conv2d(nn.Conv2d, _Op):
    def forward(self, x):
        return self.out(F.conv2d(rounded(x, self.precision),
                                 rounded(self.weight, self.precision), None, self.stride,
                                 self.padding))


class ConvTranspose2d(nn.ConvTranspose2d, _Op):
    def forward(self, x):
        return self.out(F.conv_transpose2d(rounded(x, self.precision),
                                           rounded(self.weight, self.precision), None,
                                           self.stride, self.padding))


class BatchNorm(_Op):
    """Affine BatchNorm by the batch's statistics (biased variance, eps
    1e-5), named as ``nn.BatchNorm2d``."""

    def __init__(self, n):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))

    def forward(self, x):
        var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        shape = (1, -1, 1, 1)
        return self.out((x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + BN_EPS)
                        * self.weight.reshape(shape) + self.bias.reshape(shape))


def dropout(h, generator):
    keep = 1.0 - DROPOUT_RATE
    mask = torch.rand(h.shape, generator=generator, device=h.device) < keep
    return torch.where(mask, h / keep, 0.0)


def _conv_trunk():
    return nn.Sequential(
        Conv2d(3, 32, 4, 2, 1, bias=False), Swish(),
        Conv2d(32, 64, 4, 2, 1, bias=False), BatchNorm(64), Swish(),
        Conv2d(64, 128, 4, 2, 1, bias=False), BatchNorm(128), Swish(),
        Conv2d(128, 256, 4, 1, 0, bias=False), BatchNorm(256), Swish(),
    )


class Encoder(nn.Module):
    def __init__(self, latent):
        super().__init__()
        self.conv_net = _conv_trunk()
        self.fc_net = nn.Sequential(Linear(math.prod(BOTTLENECK), 512))
        self.act = Swish()
        self.linear_means = Linear(512, latent)
        self.linear_log_var = Linear(512, latent)

    def forward(self, x, generator=None):
        """NHWC images -> (mu, logvar); dropout when given a generator."""
        h = self.conv_net(x.permute(0, 3, 1, 2))
        h = self.act(self.fc_net(h.reshape(h.shape[0], -1)))
        if generator is not None:
            h = dropout(h, generator)
        return self.linear_means(h), self.linear_log_var(h)


class Decoder(nn.Module):
    def __init__(self, latent):
        super().__init__()
        self.upsample = nn.Sequential(Linear(latent, math.prod(BOTTLENECK)))
        self.act = Swish()
        self.hallucinate = nn.Sequential(
            ConvTranspose2d(256, 128, 4, 1, 0, bias=False), BatchNorm(128), Swish(),
            ConvTranspose2d(128, 64, 4, 2, 1, bias=False), BatchNorm(64), Swish(),
            ConvTranspose2d(64, 32, 4, 2, 1, bias=False), BatchNorm(32), Swish(),
            ConvTranspose2d(32, 3, 4, 2, 1, bias=False),
        )

    def forward(self, z):
        """(B, D) -> (B, 64, 64, 3) logits, BatchNorm over these B rows."""
        h = self.act(self.upsample(z))
        return self.hallucinate(h.reshape(-1, *BOTTLENECK)).permute(0, 2, 3, 1)


def _mlp(sizes):
    layers = []
    for j in range(len(sizes) - 1):
        layers.append(Linear(sizes[j], sizes[j + 1]))
        if j < len(sizes) - 2:
            layers.append(nn.ReLU())
    return nn.Sequential(*layers)


class PoseEncoder(nn.Module):
    def __init__(self, latent):
        super().__init__()
        self.fc_net = _mlp([7, 512, 512])
        self.linear_means = Linear(512, latent)
        self.linear_log_var = Linear(512, latent)

    def forward(self, pose):
        h = self.fc_net(pose)
        return self.linear_means(h), self.linear_log_var(h)


class PoseDecoder(nn.Module):
    def __init__(self, latent):
        super().__init__()
        self.deconv_net = _mlp([latent, 512, 512, 7])

    def forward(self, z):
        return self.deconv_net(z)


def poe(mus, lvs):
    """Product of the experts' Gaussians with the reference's double eps
    (vae.py:304-318)."""
    var = torch.exp(lvs) + POE_EPS
    t = 1.0 / (var + POE_EPS)
    pd_mu = torch.sum(mus * t, dim=0) / torch.sum(t, dim=0)
    pd_var = 1.0 / torch.sum(t, dim=0)
    return pd_mu, torch.log(pd_var + POE_EPS)


class MVAE(nn.Module):
    def __init__(self, latent=256):
        super().__init__()
        self.latent = latent
        self.visual_encoder = Encoder(latent)
        self.visual_decoder = Decoder(latent)
        self.tactile_encoder = Encoder(latent)
        self.tactile_decoder = Decoder(latent)
        self.pose_encoder = PoseEncoder(latent)
        self.pose_decoder = PoseDecoder(latent)

    def set_precision(self, precision):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} is not one of {PRECISIONS}")
        for m in self.modules():
            if isinstance(m, _Op):
                m.precision = precision
        return self


def subset_elbo(model, batch, generator, kl_weight, pose_multiplier):
    """The training loss of one step (module doc) on a reference batch:
    ``visual``, ``tactile`` (B, 64, 64, 3) and ``pose`` (B, 7) inputs,
    ``t_visual``, ``t_tactile``, ``t_pose`` targets; float32."""
    mu_v, lv_v = model.visual_encoder(batch["visual"], generator)
    mu_t, lv_t = model.tactile_encoder(batch["tactile"], generator)
    mu_p, lv_p = model.pose_encoder(batch["pose"])
    zeros = torch.zeros_like(mu_v)
    experts = ((zeros, zeros), (mu_v, lv_v), (mu_t, lv_t), (mu_p, lv_p))
    b, d = mu_v.shape
    noise = torch.randn((len(SUBSETS_POSE), b, d), generator=generator,
                        device=mu_v.device)
    recon, kld, posteriors = 0.0, 0.0, []
    for k, subset in enumerate(SUBSETS_POSE):
        on = [e for e, m in zip(experts, subset) if m]
        pd_mu, pd_lv = poe(torch.stack([e[0] for e in on]), torch.stack([e[1] for e in on]))
        posteriors.append(pd_mu + noise[k] * torch.exp(0.5 * pd_lv))
        kld = kld - 0.5 * torch.sum(1 + pd_lv - pd_mu.pow(2) - pd_lv.exp())
    for k in VIS_SUBSETS:
        recon = recon + F.binary_cross_entropy_with_logits(
            model.visual_decoder(posteriors[k]), batch["t_visual"], reduction="sum")
    for k in TAC_SUBSETS:
        recon = recon + F.binary_cross_entropy_with_logits(
            model.tactile_decoder(posteriors[k]), batch["t_tactile"], reduction="sum")
    for k in POSE_SUBSETS:
        recon = recon + pose_multiplier * F.mse_loss(
            model.pose_decoder(posteriors[k]), batch["t_pose"], reduction="sum")
    return (recon + kl_weight * kld) / b


class Adam:
    """torch's default Adam (betas 0.9, 0.999, eps 1e-8), written out."""

    def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-8):
        self.params = list(params)
        self.lr, self.betas, self.eps = lr, betas, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self):
        self.t += 1
        b1, b2 = self.betas
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            m_hat = m / (1 - b1 ** self.t)
            v_hat = v / (1 - b2 ** self.t)
            p.sub_(self.lr * m_hat / (v_hat.sqrt() + self.eps))


def train_steps(model, batches, generator, kl_weight, lr, pose_multiplier):
    """Three (or ``len(batches)``) Adam steps of the subset ELBO. Returns the
    losses, the first step's gradients and the parameters after the last
    step, each by parameter name."""
    names = [n for n, _ in model.named_parameters()]
    opt = Adam(model.parameters(), lr)
    losses, first_grads = [], None
    for batch in batches:
        for p in opt.params:
            p.grad = None
        loss = subset_elbo(model, batch, generator, kl_weight, pose_multiplier)
        loss.backward()
        if first_grads is None:
            first_grads = {n: p.grad.detach().clone() for n, p in zip(names, opt.params)}
        opt.step()
        losses.append(float(loss.detach()))
    params = {n: p.detach().clone() for n, p in zip(names, opt.params)}
    return losses, first_grads, params
