"""Checkpoints with resume (port of ``mmdyn_tpu/train/checkpoint.py``).

One file per checkpoint under ``<checkpoint_dir>``, written with
``torch.save`` and read with ``torch.load(weights_only=True)``:

    epoch_<N>  best-validation snapshots (the reference's naming)
    latest     the rolling snapshot a ``--resume`` continues from

Each holds the model's and the optimizer's ``state_dict``, the step count,
the epoch, the best validation loss, the position in the epoch and the
training generator's state (the JAX package stores its PRNG key there).
The model's is the bare model's ``state_dict`` whatever the number of ranks
that trained it, so a run checkpointed by N ranks resumes in one process and
the reverse. Under a mesh rank 0 writes and every rank waits for the file;
every rank restores.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import torch

from mmdyn_tpu_torch.parallel.mesh import barrier


def save_checkpoint(checkpoint_dir, state, epoch: int, best_loss: float,
                    name: Optional[str] = None, generator=None, batch_in_epoch: int = 0,
                    mesh=None):
    """Save a snapshot as ``<checkpoint_dir>/<name>``, ``epoch_<epoch>`` by
    default (problems.py:585).

    ``batch_in_epoch == 0`` means epoch ``epoch`` completed: a resume starts
    at epoch + 1. ``batch_in_epoch == k > 0`` means the epoch was stopped
    after its first k optimizer steps: a resume replays the epoch's order
    (a function of (seed, epoch)), skips k batches and continues with the
    saved generator state, as the uninterrupted run would have.

    With ``mesh`` only rank 0 writes (the ranks hold equal states), and
    every rank returns once the file is in place.
    """
    path = Path(checkpoint_dir) / (name or f"epoch_{epoch}")
    if mesh is not None and not mesh.is_chief:
        barrier(mesh)
        return path
    payload = {
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step),
        "epoch": int(epoch),
        "best_loss": float(best_loss),
        "generator": None if generator is None else generator.get_state(),
        "batch_in_epoch": int(batch_in_epoch),
    }
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)          # a reader never sees a partial file
    if mesh is not None:
        barrier(mesh)
    return path


def latest_checkpoint(checkpoint_dir) -> Optional[Path]:
    """``latest`` if present, else the highest ``epoch_<N>``, else None."""
    d = Path(checkpoint_dir)
    if not d.exists():
        return None
    if (d / "latest").exists():
        return d / "latest"
    epochs = []
    for p in d.iterdir():
        if p.name.startswith("epoch_"):
            try:
                epochs.append((int(p.name.split("_")[1]), p))
            except ValueError:
                pass
    return max(epochs)[1] if epochs else None


def restore_checkpoint(path, state):
    """Load a snapshot into ``state``'s model and optimizer, in place, and set
    its step; returns (epoch, best_loss, generator_state_or_None,
    batch_in_epoch). Tensors are read to the CPU and copied to where the
    model and the optimizer keep theirs."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = payload["step"]
    return (payload["epoch"], payload["best_loss"], payload["generator"],
            payload["batch_in_epoch"])
