"""Problem configuration, KL annealing, optimizer factory (port of
``mmdyn_tpu/problems/base.py``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from mmdyn_tpu_torch import config as cfg_mod


@dataclasses.dataclass(frozen=True)
class ProblemConfig:
    """Static problem configuration; the same fields and defaults as the JAX
    package's (the reference CLI defaults, mmdyn/pytorch/main.py)."""

    problem_type: str = "seq_modeling"
    model_name: str = "cnn-mvae"
    input_type: str = "visual"
    use_pose: bool = False
    conditional: bool = False
    mask_loss: bool = False
    kl_weight: float = 1.0
    pose_multiplier: float = 1000.0
    latent_size: int = 256
    annealing_epochs: int = 50
    lr: float = 1e-3
    optimizer: str = "Adam"
    batchsize: int = 128
    num_epochs: int = 100
    condition_dim: Optional[int] = None
    categorical_conditions: bool = False
    compute_dtype: str = "float32"
    remat: bool = False
    augment: bool = False
    augment_shift: int = 4
    augment_brightness: float = 0.1
    noise_free: bool = False         # z = posterior mean (parity experiments)

    def __post_init__(self):
        if self.problem_type not in cfg_mod.PROBLEM_TYPES:
            raise ValueError(f"Invalid problem type {self.problem_type!r}")
        if self.input_type not in cfg_mod.INPUT_TYPES:
            raise ValueError(f"Input type {self.input_type!r} is not implemented")
        if self.optimizer not in cfg_mod.OPTIMIZERS:
            raise ValueError(f"Optimizer {self.optimizer!r} is not implemented")
        if self.augment and (self.use_pose or self.conditional
                             or self.problem_type == "regression"):
            raise ValueError(
                "--augment supports image-only problems (visual/tactile/"
                "visuotactile without --use-pose/--conditional)")

    @property
    def cross_modal(self) -> bool:
        return self.input_type == "visuotactile"

    @property
    def is_mvae(self) -> bool:
        return "mvae" in self.model_name


def select_compute_dtype(cfg: ProblemConfig, seq_length: int) -> str:
    """Resolve the ``"auto"`` activation policy as the JAX package's rule
    does off the TPU (``problems/base.py::select_compute_dtype``): its bf16
    crossover by rows per step was measured on a TPU and applies there only,
    so ``auto`` is ``float32`` on the card and on the CPU. ``seq_length`` is
    the rule's other input, unused until a crossover measured on the card
    takes its place. Explicit policies pass through."""
    if cfg.compute_dtype != "auto":
        return cfg.compute_dtype
    return "float32"


def anneal_kl(epoch: int, annealing_epochs: int) -> float:
    """kl_weight schedule (problems.py:212-216): linear warmup then 1."""
    if epoch < annealing_epochs:
        return (epoch + 1) / annealing_epochs
    return 1.0


def make_optimizer(cfg: ProblemConfig, params) -> torch.optim.Optimizer:
    """Optimizer factory matching problems.py:130-138: SGD with momentum 0.9
    and weight decay 5e-4 (added to the gradient before momentum), or Adam
    with torch's default betas and eps (the same as optax.adam's)."""
    if cfg.optimizer == "SGD":
        return torch.optim.SGD(params, lr=cfg.lr, momentum=0.9, weight_decay=5e-4)
    return torch.optim.Adam(params, lr=cfg.lr)
