"""Sequence-batch transforms (port of ``mmdyn_tpu/problems/transforms.py``).

Batches arrive as (B, T, ...). The reference flattens them to (B*T, ...)
(mmdyn/pytorch/utils/datasets.py:395-404); seq_modeling then takes frame 0 of
every sequence (problems.py:648-655) and dyn_modeling rolls by one step with
each sequence's last step patched to its resting frame (problems.py:775-788).
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


def dyn_targets(x, final):
    """One-step dynamics image targets: ``dyn_roll`` with each sequence's
    last frame replaced by its resting frame ``final`` (B, ...)."""
    b, t = x.shape[0], x.shape[1]
    target = dyn_roll(x).reshape((b, t) + tuple(x.shape[2:]))  # a fresh copy
    target[:, t - 1] = final
    return flatten_seq(target)
