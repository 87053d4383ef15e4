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
* ``dropout`` — inverted dropout drawing its mask from an explicit
  ``torch.Generator``.
* ``Mlp`` — the reference ``mlp()`` stack: Linear -> act for all but the last
  layer (vae.py:14-19); its children are numbered as the reference's.
* ``torch_default_init_`` — torch's default init (kaiming_uniform(a=sqrt(5))
  weights, U(+-1/sqrt(fan_in)) biases) drawn from an explicit generator.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn

from mmdyn_tpu_torch.config import BN_EPS


def swish(x):
    """x * sigmoid(x) (vae.py:331-334)."""
    return x * torch.sigmoid(x)


class Swish(nn.Module):
    def forward(self, x):
        return swish(x)


def train_batch_norm(x, weight, bias, groups=1, eps=BN_EPS):
    """Batch-statistics BN of an (G*N, C, ...) tensor, statistics taken per
    (group, channel) over the N rows of the group and the spatial dims."""
    n, c = x.shape[0], x.shape[1]
    if n % groups:
        raise ValueError(f"batch {n} does not split into {groups} groups")
    xg = x.reshape(groups, n // groups, c, -1)
    var, mean = torch.var_mean(xg, dim=(1, 3), correction=0, keepdim=True)
    scale = torch.rsqrt(var + eps) * weight.reshape(1, 1, c, 1)
    y = (xg - mean) * scale + bias.reshape(1, 1, c, 1)
    return y.reshape(x.shape)


class TrainBatchNorm(nn.Module):
    """Affine batch-statistics BN; parameters named as nn.BatchNorm2d's
    (``weight``, ``bias``), with no running-statistics buffers."""

    def __init__(self, num_features: int, eps: float = BN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x, groups: int = 1):
        return train_batch_norm(x, self.weight, self.bias, groups, self.eps)


def dropout(x, rate: float, generator=None):
    """Inverted dropout (flax ``nn.Dropout`` semantics): keep with
    probability 1 - rate and scale kept values by 1 / (1 - rate)."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)


class Mlp(nn.Sequential):
    """Linear -> act for all but the last layer, identity on the output."""

    def __init__(self, in_dim: int, sizes: Sequence[int], activation: str = "relu"):
        act = {"relu": nn.ReLU, "swish": Swish}[activation]
        layers = []
        for j, size in enumerate(sizes):
            layers.append(nn.Linear(in_dim, size))
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
