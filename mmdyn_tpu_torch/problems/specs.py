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

Each parser mirrors the reference ``parse_input``:

* seq_modeling   (problems.py:634-673): frame 0 of each sequence against the
  resting frames;
* dyn_modeling   (problems.py:765-803): every frame against the next, each
  sequence's last frame against its resting frame; the pose targets are
  rolled WITHOUT that patch, as the reference does (problems.py:798);
* regression     (problems.py:291-316): frame 0 against the resting pose;
* reconstruction (problems.py:96-108, 460-471): every frame against itself.
"""

from __future__ import annotations

from mmdyn_tpu_torch.problems.base import ProblemConfig
from mmdyn_tpu_torch.problems.reconstruction import (
    mvae_evaluate,
    regression_evaluate,
    vae_evaluate,
)
from mmdyn_tpu_torch.problems.transforms import (
    dyn_roll,
    dyn_targets,
    flatten_seq,
    stride_first,
)


def _first(batch, key):
    v = batch.get(key)
    return None if v is None else stride_first(v)


def _flat(batch, key):
    v = batch.get(key)
    return None if v is None else flatten_seq(v)


def _single_modality_key(cfg: ProblemConfig) -> str:
    """The batch key of a single-modality input type; the other types are
    rejected (the reference leaves model_input None and fails,
    problems.py:639-655)."""
    if cfg.input_type not in ("visual", "tactile"):
        raise ValueError(
            f"input_type '{cfg.input_type}' is not supported by "
            f"{cfg.problem_type} (valid: visual, tactile, visuotactile)")
    return cfg.input_type


def parse_seq_modeling(cfg: ProblemConfig, batch):
    inputs = {"avail": _first(batch, "avail"), "shock": _first(batch, "shock")}
    targets = {"loss_mask": _first(batch, "seg")}
    if cfg.input_type == "visuotactile":
        inputs["visual"] = stride_first(batch["visual"])
        inputs["tactile"] = stride_first(batch["tactile"])
        targets["visual"] = batch["final_visual"]
        targets["tactile"] = batch["final_tactile"]
        if cfg.use_pose:
            inputs["pose"] = stride_first(batch["pose"])
            targets["pose"] = batch["final_pose"]
    else:
        key = _single_modality_key(cfg)
        inputs["x"] = stride_first(batch[key])
        targets["x"] = batch[f"final_{key}"]
    return inputs, targets


def parse_dyn_modeling(cfg: ProblemConfig, batch):
    inputs = {"avail": _flat(batch, "avail"), "shock": _flat(batch, "shock")}
    targets = {"loss_mask": _flat(batch, "seg")}
    if cfg.input_type == "visuotactile":
        inputs["visual"] = flatten_seq(batch["visual"])
        inputs["tactile"] = flatten_seq(batch["tactile"])
        targets["visual"] = dyn_targets(batch["visual"], batch["final_visual"])
        targets["tactile"] = dyn_targets(batch["tactile"], batch["final_tactile"])
        if cfg.use_pose:
            inputs["pose"] = flatten_seq(batch["pose"])
            targets["pose"] = dyn_roll(batch["pose"])     # no resting patch
    else:
        key = _single_modality_key(cfg)
        inputs["x"] = flatten_seq(batch[key])
        targets["x"] = dyn_targets(batch[key], batch[f"final_{key}"])
    return inputs, targets


def parse_regression(cfg: ProblemConfig, batch):
    key = _single_modality_key(cfg)
    inputs = {"x": stride_first(batch[key]), "shock": _first(batch, "shock")}
    return inputs, {"pose": batch["final_pose"]}


def parse_reconstruction(cfg: ProblemConfig, batch):
    """Plain autoencoding of every frame (targets == inputs)."""
    inputs = {"shock": _flat(batch, "shock")}
    targets = {}
    if cfg.input_type == "visuotactile":
        inputs["visual"] = flatten_seq(batch["visual"])
        inputs["tactile"] = flatten_seq(batch["tactile"])
        targets["visual"] = inputs["visual"]
        targets["tactile"] = inputs["tactile"]
        if cfg.use_pose:
            inputs["pose"] = flatten_seq(batch["pose"])
            targets["pose"] = inputs["pose"]
    else:
        key = _single_modality_key(cfg)
        inputs["x"] = flatten_seq(batch[key])
        targets["x"] = inputs["x"]
    return inputs, targets


PROBLEM_PARSERS = {
    "seq_modeling": parse_seq_modeling,
    "dyn_modeling": parse_dyn_modeling,
    "regression": parse_regression,
    "reconstruction": parse_reconstruction,
}


def step_rows(cfg: ProblemConfig, seq_length: int) -> int:
    """The rows one step trains: every frame of a sequence where the parser
    flattens the sequences (dyn_modeling, reconstruction), else one a
    sequence."""
    per_sequence = seq_length if cfg.problem_type in ("dyn_modeling", "reconstruction") else 1
    return cfg.batchsize * per_sequence


def parse_batch(cfg: ProblemConfig, batch):
    return PROBLEM_PARSERS[cfg.problem_type](cfg, batch)


def evaluate(cfg: ProblemConfig, model, generator, inputs, targets, kl_weight):
    """Dispatch to the model-appropriate loss (problems.py set_criterion)."""
    if cfg.problem_type == "regression":
        return regression_evaluate(model, generator, inputs, targets, kl_weight, cfg)
    if cfg.is_mvae and cfg.cross_modal:
        return mvae_evaluate(model, generator, inputs, targets, kl_weight, cfg)
    return vae_evaluate(model, generator, inputs, targets, kl_weight, cfg)
