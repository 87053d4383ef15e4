"""ELBO losses with reference-exact reduction semantics (port of
``mmdyn_tpu/ops/losses.py``; reference mmdyn/pytorch/problems/problems.py:
401-458).

* ``elbo_loss``: (BCE_with_logits_sum + kl_weight * KLD) / batch_size, with
  KLD = -0.5 * sum(1 + logvar - mu^2 - exp(logvar)) over all elements. An
  optional loss mask multiplies BOTH the logits and the targets before the
  BCE (problems.py:409-411), kept for parity.
* ``mvae_elbo_loss``: images (ndim > 2) take BCE-with-logits, vectors take
  pose_multiplier * MSE, all sum-reduced, plus kl_weight * KLD, / batch_size.
"""

from __future__ import annotations

import torch


def _reduce(loss, reduction):
    if reduction == "sum":
        return torch.sum(loss)
    if reduction == "mean":
        return torch.mean(loss)
    return loss


def bce_with_logits(logits, targets, reduction="sum"):
    """max(x, 0) - x*z + log1p(exp(-|x|)), f32 math."""
    x = logits.float()
    loss = torch.clamp_min(x, 0.0) - x * targets + torch.log1p(torch.exp(-torch.abs(x)))
    return _reduce(loss, reduction)


def mse(pred, targets, reduction="sum"):
    """Squared error matching torch.nn.functional.mse_loss."""
    return _reduce(torch.square(pred - targets), reduction)


def kl_divergence(mu, logvar):
    """KLD(q || N(0, I)) summed over all elements (problems.py:406)."""
    return -0.5 * torch.sum(1.0 + logvar - torch.square(mu) - torch.exp(logvar))


def elbo_loss(recon_logits, x, mu, logvar, kl_weight=1.0, loss_mask=None,
              batch_size=None):
    """VAE ELBO (problems.py:401-419): (BCE_sum + kl_weight * KLD) / B, B
    the rows of ``x`` unless ``batch_size`` (the global batch of a rank's
    rows) is given."""
    batch_size = x.shape[0] if batch_size is None else batch_size
    kld = kl_divergence(mu, logvar)
    recon = torch.reshape(recon_logits, x.shape)
    if loss_mask is not None:
        recon = recon * loss_mask
        x = x * loss_mask
    bce = bce_with_logits(recon, x, reduction="sum")
    return (bce + kl_weight * kld) / batch_size


def mvae_elbo_loss(recons, xs, mu, logvar, kl_weight=1.0, pose_multiplier=1000.0,
                   loss_mask=None):
    """Subset-ELBO of one modality subset (problems.py:421-458)."""
    if len(recons) != len(xs):
        raise ValueError("one target per reconstruction expected")
    batch_size = xs[0].shape[0]
    kld = kl_divergence(mu, logvar)
    recon_error = 0.0
    for recon, x in zip(recons, xs):
        if recon.dim() > 2:
            recon = torch.reshape(recon, x.shape)
            if loss_mask is not None:
                recon = recon * loss_mask
                x = x * loss_mask
            recon_error = recon_error + bce_with_logits(recon, x, reduction="sum")
        else:
            if loss_mask is not None:
                recon = recon * loss_mask
                x = x * loss_mask
            recon_error = recon_error + pose_multiplier * mse(recon, x, reduction="sum")
    return (recon_error + kl_weight * kld) / batch_size
