"""Reattach a saved run: ``problem.pkl`` -> ``ProblemConfig`` (port of
``mmdyn_tpu/utils/runs.py``). The training CLI pickles its arguments next to
each run, as the reference does (mmdyn/pytorch/main.py:69)."""

from __future__ import annotations

import json
import pickle
from pathlib import Path

from mmdyn_tpu_torch.problems.base import ProblemConfig


def load_run_args(run_dir) -> dict:
    """``<run>/problem.pkl`` as a plain dict."""
    with open(Path(run_dir) / "problem.pkl", "rb") as f:
        saved = pickle.load(f)
    return saved if isinstance(saved, dict) else vars(saved)


def trained_policy(run_dir) -> str:
    """The activation policy a run trained at, ``auto`` resolved, as its
    ``norms.json`` records it."""
    with open(Path(run_dir) / "norms.json") as f:
        return json.load(f)["compute_dtype"]


def config_from_args(saved: dict, compute_dtype: str, batchsize=None):
    """The ``ProblemConfig`` a run was trained with, for evaluation (no
    epochs), by the CLI's flag -> field mapping; flags a run does not record
    take the reference defaults. ``compute_dtype`` is the policy it trained
    at (``trained_policy``)."""
    return ProblemConfig(
        problem_type=saved["problem_type"],
        model_name=saved["model_name"],
        input_type=saved["input_type"],
        use_pose=saved.get("use_pose", False),
        conditional=saved.get("conditional", False),
        mask_loss=saved.get("mask_loss", False),
        kl_weight=saved.get("kl_weight", 1.0),
        pose_multiplier=saved.get("pose_multiplier", 1000.0),
        latent_size=saved.get("latent_size", 256),
        annealing_epochs=saved.get("annealing_epochs", 50),
        lr=saved.get("lr", 1e-3),
        optimizer=saved.get("optimizer", "Adam"),
        batchsize=batchsize or saved.get("batchsize", 128),
        num_epochs=0,
        compute_dtype=compute_dtype,
    )
