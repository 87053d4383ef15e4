"""Product-of-experts Gaussian fusion and reparameterisation (port of
``mmdyn_tpu/ops/poe.py``).

Numerical contract follows the reference exactly
(mmdyn/pytorch/models/vae.py:304-318):

    var       = exp(logvar) + eps
    T         = 1 / (var + eps)          # eps applied twice, kept for parity
    pd_mu     = sum(mu * T, experts) / sum(T, experts)
    pd_var    = 1 / sum(T, experts)
    pd_logvar = log(pd_var + eps)

with eps = 1e-8. The prior expert N(0, I) has mu = logvar = 0 (vae.py:321-328).
"""

from __future__ import annotations

import torch

from mmdyn_tpu_torch.config import POE_EPS
from mmdyn_tpu_torch.parallel.mesh import global_draw


def prior_expert(shape, device=None, dtype=torch.float32):
    """Universal N(0, I) prior expert: zero mean and zero log-variance."""
    zeros = torch.zeros(shape, device=device, dtype=dtype)
    return zeros, zeros.clone()


def product_of_experts(mu, logvar, eps=POE_EPS):
    """Precision-weighted fusion of (M, ..., D) experts -> (..., D) each."""
    var = torch.exp(logvar) + eps
    t = 1.0 / (var + eps)
    sum_t = torch.sum(t, dim=0)
    pd_mu = torch.sum(mu * t, dim=0) / sum_t
    pd_var = 1.0 / sum_t
    return pd_mu, torch.log(pd_var + eps)


def masked_poe(mu, logvar, mask, eps=POE_EPS):
    """PoE over a masked subset of the (M, B, D) experts; ``mask`` is (M,)
    with 1.0 where the expert participates (the prior row always on)."""
    mask = torch.as_tensor(mask, dtype=mu.dtype, device=mu.device)
    mask = mask.reshape((-1,) + (1,) * (mu.dim() - 1))
    var = torch.exp(logvar) + eps
    t = mask / (var + eps)
    sum_t = torch.sum(t, dim=0)
    pd_mu = torch.sum(mu * t, dim=0) / sum_t
    pd_var = 1.0 / sum_t
    return pd_mu, torch.log(pd_var + eps)


def reparametrize(generator, mu, logvar):
    """z = eps * std + mu with eps ~ N(0, I) drawn from ``generator``
    (vae.py:52-61). The generator must live on mu's device; inside
    ``parallel.sharded`` the noise is this rank's rows of a global draw."""
    std = torch.exp(0.5 * logvar)
    eps = global_draw(lambda s: torch.randn(s, generator=generator, device=mu.device,
                                            dtype=mu.dtype), mu.shape)
    return eps * std + mu
