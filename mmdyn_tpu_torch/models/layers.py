"""Building-block layers (port of ``mmdyn_tpu/models/layers.py``).

The JAX layers re-create torch semantics in flax; here torch's own modules
are the counterparts: ``Conv2d`` / ``ConvTranspose2d`` with torch (k, s, p)
are ``nn.Conv2d`` / ``nn.ConvTranspose2d`` and ``Dense`` is ``nn.Linear``,
all NCHW inside the models. What torch does not offer in the reference's
form is here:

* ``swish`` — x * sigmoid(x) (vae.py:331-334).
* ``train_batch_norm`` — BatchNorm that always normalises by the current
  batch statistics (biased variance, eps 1e-5) and keeps no running
  statistics: the reference evaluates in train mode (problems.py:174).
  ``groups`` splits the batch into independent groups with their own
  statistics, which is how the subset decoders keep per-subset BN while their
  convolutions run on all subsets at once.
* ``TrainBatchNorm`` modes, a serving knob (JAX ``layers.py:134-176``):
  ``batch`` (training, the default), ``collect`` (batch statistics, also
  recorded in the module's ``mean`` / ``var`` buffers) and ``frozen``
  (normalise by those buffers: per-example deterministic). The buffers are
  not persistent, so a trained ``state_dict`` loads strictly into a model of
  any mode; ``bn_stats`` / ``load_bn_stats`` move them as a dict keyed by
  module name, as the JAX ``bn_stats`` collection does.
* ``run_sequential`` — a trunk's ``nn.Sequential`` with each BatchNorm +
  swish pair run as one ``ops.kernels.fused_bn_swish`` call (on the card a
  hand-written kernel; on the CPU its plain version) and each lone swish as
  ``F.silu``, for float32 activations (a pair in mode ``batch`` or
  ``collect``) outside a multi-rank mesh; ``bfloat16_full``, ``frozen`` and
  the mesh's all-reduced statistics keep the modules' own calls.
* ``dropout`` — inverted dropout drawing its mask from an explicit
  ``torch.Generator``.
* Data parallelism: inside ``parallel.sharded(mesh)`` over more than one
  rank, the batch-statistics modes take each statistic over every rank's
  rows (``parallel.mesh.var_mean``) and dropout draws its mask at the global
  shape, keeping this rank's rows, as the JAX package's SPMD step does.
* ``Mlp`` — the reference ``mlp()`` stack: Linear -> act for all but the last
  layer (vae.py:14-19); its children are numbered as the reference's.
* ``Linear`` / ``Conv2d`` / ``ConvTranspose2d`` — torch's layers under an
  activation policy (``compute_dtype``, JAX ``layers.py:201-227``):

  - ``float32``: a convolution runs through ``_ConvF32``: the forward of a
    ``Conv2d`` and the data gradient of a ``ConvTranspose2d`` are
    ``ops.kernels.conv_fprop_f32``; the data gradient of a ``Conv2d`` and
    the forward of a ``ConvTranspose2d`` are ``ops.kernels.conv_dgrad_f32``;
    every weight gradient is ``ops.kernels.conv_wgrad_f32`` (on the card
    hand-written kernels that sum in a fixed order; on the CPU their plain
    versions). Their geometry is the cnn models' (4 x 4 kernels, stride 1 or
    2, padding 0 or 1): a convolution of any other raises in its forward.
  - ``bfloat16``: the input and the weight are cast to bf16 for the product
    (the tensor cores accumulate in float32), the output is upcast to
    float32, and the bias is added in float32.
  - ``bfloat16_full``: the same product, but the output stays bf16, and so
    do the bias add and everything elementwise after it.

  Parameters, and so Adam's state, stay float32 under every policy.
* ``torch_default_init_`` — torch's default init (kaiming_uniform(a=sqrt(5))
  weights, U(+-1/sqrt(fan_in)) biases) drawn from an explicit generator.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from mmdyn_tpu_torch.config import BN_EPS
from mmdyn_tpu_torch.ops.kernels import (conv_dgrad_f32, conv_fprop_f32, conv_wgrad_f32,
                                          fused_bn_swish)
from mmdyn_tpu_torch.parallel.mesh import active_mesh, global_draw, var_mean

POLICIES = ("float32", "bfloat16", "bfloat16_full")


def swish(x):
    """x * sigmoid(x) (vae.py:331-334)."""
    return x * torch.sigmoid(x)


class Swish(nn.Module):
    def forward(self, x):
        return swish(x)


def check_policy(compute_dtype: str) -> str:
    """``compute_dtype`` if it names a policy; ``auto`` must be resolved
    first (``problems.base.select_compute_dtype``)."""
    if compute_dtype not in POLICIES:
        raise ValueError(f"compute_dtype {compute_dtype!r} is not one of {POLICIES}")
    return compute_dtype


def cast_compute(x, weight, compute_dtype):
    """The operands of a conv or matmul in the policy's compute dtype (JAX
    ``_cast_compute``): both bf16 under the bf16 policies."""
    if compute_dtype == "float32":
        return x, weight
    return x.to(torch.bfloat16), weight.to(torch.bfloat16)


def uncast(y, compute_dtype):
    """The dtype written at the layer boundary (JAX ``_uncast``): float32,
    except under ``bfloat16_full``, where activations stay bf16."""
    return y if compute_dtype == "bfloat16_full" else y.float()


def train_batch_norm(x, weight, bias, groups=1, eps=BN_EPS):
    """Batch-statistics BN of an (G*N, C, ...) tensor, statistics taken per
    (group, channel) over the N rows of the group and the spatial dims (and
    over every rank's rows inside ``parallel.sharded``).

    The statistics are float32 whatever the activation dtype; a bf16 input
    is normalised in bf16, as JAX ``_train_bn_fwd_math`` does (upcasting
    first, since ``var_mean`` of a bf16 tensor returns bf16 statistics)."""
    n, c = x.shape[0], x.shape[1]
    if n % groups:
        raise ValueError(f"batch {n} does not split into {groups} groups")
    xg = x.reshape(groups, n // groups, c, -1)
    mesh = active_mesh()
    if mesh is None:
        var, mean = torch.var_mean(xg.float(), dim=(1, 3), correction=0, keepdim=True)
    else:
        var, mean = var_mean(xg.float(), (1, 3), mesh)
    inv = torch.rsqrt(var + eps)
    weight, bias = weight.reshape(1, 1, c, 1), bias.reshape(1, 1, c, 1)
    if x.dtype == torch.float32:
        y = (xg - mean) * (inv * weight) + bias
    else:
        dt = x.dtype
        y = (xg - mean.to(dt)) * inv.to(dt) * weight.to(dt) + bias.to(dt)
    return y.reshape(x.shape)


def frozen_batch_norm(x, mean, var, weight, bias, eps=BN_EPS):
    """BN of an (N, C, ...) tensor by stored float32 statistics, in the
    activation dtype, in the JAX frozen mode's order:
    (x - mean) * rsqrt(var + eps) * weight + bias."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    dt = x.dtype
    inv = torch.rsqrt(var + eps)
    return ((x - mean.to(dt).reshape(shape)) * inv.to(dt).reshape(shape)
            * weight.to(dt).reshape(shape) + bias.to(dt).reshape(shape))


BN_MODES = ("batch", "collect", "frozen")


class TrainBatchNorm(nn.Module):
    """Affine BN; parameters named as nn.BatchNorm2d's (``weight``,
    ``bias``). ``mode`` is one of ``BN_MODES`` (module doc); the serving
    statistics live in the non-persistent buffers ``mean`` and ``var``."""

    def __init__(self, num_features: int, eps: float = BN_EPS, mode: str = "batch"):
        super().__init__()
        if mode not in BN_MODES:
            raise ValueError(f"BatchNorm mode {mode!r} is not one of {BN_MODES}")
        self.eps = eps
        self.mode = mode
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features), persistent=False)
        self.register_buffer("var", torch.ones(num_features), persistent=False)

    def forward(self, x, groups: int = 1):
        if self.mode == "frozen":      # per-example: ``groups`` has no effect
            return frozen_batch_norm(x, self.mean, self.var, self.weight, self.bias,
                                     self.eps)
        self._collect(x, groups)
        return train_batch_norm(x, self.weight, self.bias, groups, self.eps)

    def forward_swish(self, x, groups: int = 1):
        """swish(self(x, groups)) as one ``fused_bn_swish`` call, for a
        float32 ``x`` outside a multi-rank mesh in mode ``batch`` or
        ``collect`` (``fusable``)."""
        self._collect(x, groups)
        return fused_bn_swish(x, self.weight, self.bias, groups, self.eps)

    def fusable(self, x) -> bool:
        return self.mode != "frozen" and _fusable(x)

    def _collect(self, x, groups):
        """In mode ``collect``, record the batch statistics in the buffers."""
        if self.mode != "collect":
            return
        if groups != 1:
            raise ValueError("a collect pass takes one group of statistics")
        mesh = active_mesh()
        if mesh is None:
            var, mean = torch.var_mean(x.detach().float(), dim=(0, 2, 3), correction=0)
        else:
            var, mean = var_mean(x.detach().float(), (0, 2, 3), mesh, keepdim=False)
        self.mean.copy_(mean)
        self.var.copy_(var)


def _fusable(x) -> bool:
    """Whether BatchNorm + swish of ``x`` takes the fused kernel, and swish
    ``F.silu``: float32 activations (not ``bfloat16_full``'s bf16), outside a
    mesh of more than one rank, whose statistics need the ranks' all-reduce.
    A ``torch.export`` or ``torch.compile`` trace records the kernel's custom
    operator."""
    return x.dtype == torch.float32 and active_mesh() is None


def run_sequential(seq: nn.Sequential, h, groups: int = 1):
    """``seq`` applied to ``h``, its children called in order as the
    ``Sequential`` would, except that a ``TrainBatchNorm`` followed by a
    ``Swish`` runs as one ``fused_bn_swish`` where ``TrainBatchNorm.fusable``
    allows (else the pair as two module calls), and a lone ``Swish`` as
    ``F.silu`` where ``_fusable`` allows; each BatchNorm takes
    ``groups``. The children, their indices and the ``state_dict`` stay as
    they are."""
    layers = list(seq)
    i = 0
    while i < len(layers):
        layer = layers[i]
        pair = (isinstance(layer, TrainBatchNorm) and i + 1 < len(layers)
                and isinstance(layers[i + 1], Swish))
        if pair and layer.fusable(h):
            h = layer.forward_swish(h, groups)
        elif pair:
            h = layers[i + 1](layer(h, groups))
        elif isinstance(layer, TrainBatchNorm):
            h = layer(h, groups)
        elif isinstance(layer, Swish) and _fusable(h):
            h = F.silu(h)
        else:
            h = layer(h)
        i += 2 if pair else 1
    return h


def bn_stats(model: nn.Module) -> dict:
    """The serving statistics of every ``TrainBatchNorm`` in ``model``, as
    {module name: {"mean", "var"}} float32 copies; empty for a BN-free
    model."""
    return {name: {"mean": m.mean.clone(), "var": m.var.clone()}
            for name, m in model.named_modules() if isinstance(m, TrainBatchNorm)}


@torch.no_grad()
def load_bn_stats(model: nn.Module, stats: dict) -> None:
    """Copy ``stats`` (as ``bn_stats`` returns them) into ``model``'s BN
    buffers; every BN layer must be given, and no other name."""
    layers = {name: m for name, m in model.named_modules() if isinstance(m, TrainBatchNorm)}
    if set(stats) != set(layers):
        raise ValueError(f"BatchNorm statistics for {sorted(stats)} do not match the "
                         f"model's BatchNorm layers {sorted(layers)}")
    for name, m in layers.items():
        m.mean.copy_(torch.as_tensor(stats[name]["mean"], dtype=torch.float32))
        m.var.copy_(torch.as_tensor(stats[name]["var"], dtype=torch.float32))


def dropout(x, rate: float, generator=None):
    """Inverted dropout (flax ``nn.Dropout`` semantics): keep with
    probability 1 - rate and scale kept values by 1 / (1 - rate)."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = global_draw(lambda s: torch.rand(s, generator=generator, device=x.device),
                       x.shape) < keep
    return torch.where(mask, x / keep, 0.0)


def _with_bias(y, bias, spatial_dims=0):
    """``y`` plus the bias in ``y``'s dtype, on the channel axis that
    ``spatial_dims`` trailing dims follow."""
    if bias is None:
        return y
    return y + bias.to(y.dtype).reshape((-1,) + (1,) * spatial_dims)


class Linear(nn.Linear):
    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: str = "float32"):
        super().__init__(in_features, out_features, bias)
        self.compute_dtype = check_policy(compute_dtype)

    def forward(self, x):
        if self.compute_dtype == "float32":
            return super().forward(x)
        xc, wc = cast_compute(x, self.weight, self.compute_dtype)
        return _with_bias(uncast(F.linear(xc, wc), self.compute_dtype), self.bias)


class _ConvF32(torch.autograd.Function):
    """A float32 convolution, transposed or not. The forward of a
    convolution and the data gradient of a transposed one (the same sum) are
    ``conv_fprop_f32``; the data gradient of a convolution and the forward of
    a transposed one are ``conv_dgrad_f32``; every weight gradient is
    ``conv_wgrad_f32``; the bias gradient is the call autograd makes without
    it (``aten.convolution_backward``). The bias is added after the
    kernel."""

    @staticmethod
    def forward(ctx, x, weight, bias, transposed, stride, padding, output_padding,
                dilation, groups):
        ctx.save_for_backward(x, weight)
        ctx.conv = (transposed, stride, padding, output_padding, dilation, groups)
        ctx.bias_sizes = None if bias is None else list(bias.shape)
        if not transposed:
            y = conv_fprop_f32(x, weight, stride, padding, dilation, groups)
            return _with_bias(y, bias, 2)
        size = [(n - 1) * s - 2 * p + k + o for n, s, p, k, o in zip(
            x.shape[2:], stride, padding, weight.shape[2:], output_padding)]
        y = conv_dgrad_f32(x, weight, size, stride, padding, dilation, groups)
        return _with_bias(y, bias, 2)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        transposed, stride, padding, output_padding, dilation, groups = ctx.conv
        dx = dw = db = None
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        g = grad.contiguous()          # the decoders' last one arrives as an NHWC view
        if need_x and not transposed:
            dx = conv_dgrad_f32(g, weight, x.shape[2:], stride, padding, dilation, groups)
        if need_x and transposed:
            dx = conv_fprop_f32(g, weight, stride, padding, dilation, groups)
        if need_b:
            db = torch.ops.aten.convolution_backward(
                grad, x, weight, ctx.bias_sizes, stride, padding, dilation, transposed,
                output_padding, groups, (False, False, True))[2]
        if need_w:
            # a transposed convolution's weight gradient is the convolution's
            # with the roles of input and output swapped
            pair = (g, x) if transposed else (x, g)
            dw = conv_wgrad_f32(*pair, weight.shape[2:], stride, padding, dilation, groups)
        return dx, dw, db, None, None, None, None, None, None


class Conv2d(nn.Conv2d):
    def __init__(self, *args, compute_dtype: str = "float32", **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = check_policy(compute_dtype)

    def forward(self, x):
        if self.compute_dtype == "float32":
            return _ConvF32.apply(x, self.weight, self.bias, False, self.stride, self.padding,
                                  self.output_padding, self.dilation, self.groups)
        xc, wc = cast_compute(x, self.weight, self.compute_dtype)
        y = F.conv2d(xc, wc, None, self.stride, self.padding, self.dilation, self.groups)
        return _with_bias(uncast(y, self.compute_dtype), self.bias, 2)


class ConvTranspose2d(nn.ConvTranspose2d):
    def __init__(self, *args, compute_dtype: str = "float32", **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = check_policy(compute_dtype)

    def forward(self, x):
        if self.compute_dtype == "float32":
            return _ConvF32.apply(x, self.weight, self.bias, True, self.stride, self.padding,
                                  self.output_padding, self.dilation, self.groups)
        xc, wc = cast_compute(x, self.weight, self.compute_dtype)
        y = F.conv_transpose2d(xc, wc, None, self.stride, self.padding,
                               self.output_padding, self.groups, self.dilation)
        return _with_bias(uncast(y, self.compute_dtype), self.bias, 2)


class Mlp(nn.Sequential):
    """Linear -> act for all but the last layer, identity on the output."""

    def __init__(self, in_dim: int, sizes: Sequence[int], activation: str = "relu",
                 compute_dtype: str = "float32"):
        act = {"relu": nn.ReLU, "swish": Swish}[activation]
        layers = []
        for j, size in enumerate(sizes):
            layers.append(Linear(in_dim, size, compute_dtype=compute_dtype))
            in_dim = size
            if j < len(sizes) - 1:
                layers.append(act())
        super().__init__(*layers)


def torch_default_init_(module: nn.Module, generator: torch.Generator) -> None:
    """Re-draw every Linear / Conv / ConvTranspose weight and bias with torch's
    default bounds, 1/sqrt(fan_in), from ``generator``. fan_in is computed as
    torch does: dim 1 times the kernel area, which for a ConvTranspose2d
    weight (in, out, kh, kw) is out*kh*kw."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
                w = m.weight
                fan_in = w.shape[1] * math.prod(w.shape[2:])
                bound = 1.0 / math.sqrt(fan_in)
                w.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)
