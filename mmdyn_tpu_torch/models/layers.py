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

  - ``float32``: torch's own forward, unchanged.
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
        if self.mode == "collect":
            if groups != 1:
                raise ValueError("a collect pass takes one group of statistics")
            mesh = active_mesh()
            if mesh is None:
                var, mean = torch.var_mean(x.detach().float(), dim=(0, 2, 3), correction=0)
            else:
                var, mean = var_mean(x.detach().float(), (0, 2, 3), mesh, keepdim=False)
            self.mean.copy_(mean)
            self.var.copy_(var)
        return train_batch_norm(x, self.weight, self.bias, groups, self.eps)


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


class Conv2d(nn.Conv2d):
    def __init__(self, *args, compute_dtype: str = "float32", **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = check_policy(compute_dtype)

    def forward(self, x):
        if self.compute_dtype == "float32":
            return super().forward(x)
        xc, wc = cast_compute(x, self.weight, self.compute_dtype)
        y = F.conv2d(xc, wc, None, self.stride, self.padding, self.dilation, self.groups)
        return _with_bias(uncast(y, self.compute_dtype), self.bias, 2)


class ConvTranspose2d(nn.ConvTranspose2d):
    def __init__(self, *args, compute_dtype: str = "float32", **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = check_policy(compute_dtype)

    def forward(self, x):
        if self.compute_dtype == "float32":
            return super().forward(x)
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
