"""Batch parsing per problem type and evaluation dispatch (port of
``mmdyn_tpu/problems/specs.py``).

Batches are dicts of (B, T, ...) tensors, images NHWC:

    visual, tactile:       (B, T, 64, 64, 3) float32 in [0, 1]
    pose:                  (B, T, 7)
    avail:                 (B, T, 2)
    shock:                 (B, T, S)    optional
    final_visual/tactile:  (B, 64, 64, 3) resting frames
    final_pose:            (B, 7)
    seg:                   (B, T, 64, 64, 3) loss masks

Ported so far: seq_modeling (problems.py:634-673), frame 0 of each sequence
against the resting frames. The other problem types raise.
"""

from __future__ import annotations

from mmdyn_tpu_torch.problems.base import ProblemConfig
from mmdyn_tpu_torch.problems.reconstruction import mvae_evaluate
from mmdyn_tpu_torch.problems.transforms import stride_first


def _first(batch, key):
    v = batch.get(key)
    return None if v is None else stride_first(v)


def parse_seq_modeling(cfg: ProblemConfig, batch):
    inputs = {"avail": _first(batch, "avail"), "shock": _first(batch, "shock")}
    targets = {"loss_mask": _first(batch, "seg")}
    if cfg.input_type != "visuotactile":
        raise NotImplementedError(
            f"seq_modeling with input_type {cfg.input_type!r} is not ported yet")
    inputs["visual"] = stride_first(batch["visual"])
    inputs["tactile"] = stride_first(batch["tactile"])
    targets["visual"] = batch["final_visual"]
    targets["tactile"] = batch["final_tactile"]
    if cfg.use_pose:
        inputs["pose"] = stride_first(batch["pose"])
        targets["pose"] = batch["final_pose"]
    return inputs, targets


PROBLEM_PARSERS = {"seq_modeling": parse_seq_modeling}


def parse_batch(cfg: ProblemConfig, batch):
    parser = PROBLEM_PARSERS.get(cfg.problem_type)
    if parser is None:
        raise NotImplementedError(f"{cfg.problem_type} is not ported yet")
    return parser(cfg, batch)


def evaluate(cfg: ProblemConfig, model, generator, inputs, targets, kl_weight):
    """Dispatch to the model-appropriate loss (problems.py set_criterion)."""
    if cfg.problem_type != "regression" and cfg.is_mvae and cfg.cross_modal:
        return mvae_evaluate(model, generator, inputs, targets, kl_weight, cfg)
    raise NotImplementedError(
        f"{cfg.model_name} on {cfg.problem_type} is not ported yet")
