"""Train state (port of ``mmdyn_tpu/train/state.py``).

The JAX package keeps (step, params, opt_state) as a pure pytree; in torch
the model owns its parameters and the optimizer its moments, both updated in
place, so the state is a small holder of the step count, model and optimizer.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer


def create_train_state(model, optimizer) -> TrainState:
    return TrainState(step=0, model=model, optimizer=optimizer)
