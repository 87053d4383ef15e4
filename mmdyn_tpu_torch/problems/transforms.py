"""Sequence-batch transforms (port of ``mmdyn_tpu/problems/transforms.py``).

Batches arrive as (B, T, ...). The reference flattens them to (B*T, ...)
(mmdyn/pytorch/utils/datasets.py:395-404); seq_modeling then takes frame 0 of
every sequence (problems.py:648-655) and dyn_modeling rolls by one step with
each sequence's last step patched to its resting frame (problems.py:775-788).

``augment_batch`` is the JAX package's train-time augmentation (beyond the
reference): per sequence a flip of the W axis, an edge-padded integer shift
and a brightness scale. It is split into the draws (``augment_draws``, from
a ``torch.Generator``) and their application (``apply_augment``), so the same
draws can be applied on both sides of a parity test.
"""

from __future__ import annotations

import torch


def flatten_seq(x):
    """(B, T, ...) -> (B*T, ...), the seq_collate_fn layout."""
    return x.reshape((-1,) + tuple(x.shape[2:]))


def stride_first(x):
    """(B, T, ...) -> (B, ...): frame 0 of each sequence (``flat[::T]``)."""
    return x[:, 0]


def dyn_roll(x):
    """(B, T, ...) -> (B*T, ...) shifted by one over the flattened axis,
    wrapping across sequence boundaries like ``torch.roll(flat, -1, 0)``."""
    return torch.roll(flatten_seq(x), -1, dims=0)


def _geom(x, flip, dy, dx):
    """Flip the W axis of (B, T, H, W, C) frames where ``flip``, then shift
    them by (dy, dx) pixels with edge padding, per sequence b. The shifted
    frame reads pixel (clamp(y + dy), clamp(x + dx)) of the flipped one, as
    ``jnp.pad(mode="edge")`` followed by ``dynamic_slice`` does."""
    b, _, h, w, _ = x.shape
    rows = torch.clamp(torch.arange(h, device=x.device) + dy[:, None], 0, h - 1)
    cols = torch.clamp(torch.arange(w, device=x.device) + dx[:, None], 0, w - 1)
    cols = torch.where(flip[:, None], w - 1 - cols, cols)
    x = torch.gather(x, 2, rows.view(b, 1, h, 1, 1).expand(x.shape))
    return torch.gather(x, 3, cols.view(b, 1, 1, w, 1).expand(x.shape))


def augment_draws(generator, b, max_shift=4, brightness=0.1, device=None):
    """Per-sequence draws of ``augment_batch``: flip (B,) bool with p=0.5,
    dy and dx (B,) integers in [-max_shift, max_shift], scale (B,) uniform in
    1 +- brightness."""
    flip = torch.rand(b, generator=generator, device=device) < 0.5
    dy = torch.randint(-max_shift, max_shift + 1, (b,), generator=generator,
                       device=device)
    dx = torch.randint(-max_shift, max_shift + 1, (b,), generator=generator,
                       device=device)
    u = torch.rand(b, generator=generator, device=device)
    return flip, dy, dx, 1.0 + (2.0 * u - 1.0) * brightness


def apply_augment(batch, flip, dy, dx, scale):
    """Apply the draws to a batch (transforms.py:68-93): the same geometry to
    every frame of a sequence, its resting frames and its ``seg`` mask;
    brightness (then a clip to [0, 1]) to the photometric keys only."""
    out = dict(batch)
    for k in ("visual", "tactile"):
        if batch.get(k) is None:
            continue
        out[k] = torch.clamp(_geom(batch[k], flip, dy, dx)
                             * scale[:, None, None, None, None], 0.0, 1.0)
        fk = f"final_{k}"
        if batch.get(fk) is not None:
            fin = _geom(batch[fk][:, None], flip, dy, dx)[:, 0]
            out[fk] = torch.clamp(fin * scale[:, None, None, None], 0.0, 1.0)
    if batch.get("seg") is not None:
        out["seg"] = _geom(batch["seg"], flip, dy, dx)
    return out


def augment_batch(batch, generator, max_shift=4, brightness=0.1):
    """Train-time augmentation of a (B, T, H, W, C) batch with draws from
    ``generator`` (on the batch's device); a batch with no image key is
    returned as it is."""
    imgs = [k for k in ("visual", "tactile") if batch.get(k) is not None]
    if not imgs:
        return batch
    x = batch[imgs[0]]
    return apply_augment(batch, *augment_draws(generator, x.shape[0], max_shift,
                                               brightness, x.device))


def dyn_targets(x, final):
    """One-step dynamics image targets: ``dyn_roll`` with each sequence's
    last frame replaced by its resting frame ``final`` (B, ...)."""
    b, t = x.shape[0], x.shape[1]
    target = dyn_roll(x).reshape((b, t) + tuple(x.shape[2:]))  # a fresh copy
    target[:, t - 1] = final
    return flatten_seq(target)
