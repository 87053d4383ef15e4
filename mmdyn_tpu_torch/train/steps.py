"""Train / eval / sample steps (port of ``mmdyn_tpu/train/steps.py``).

Each factory resolves its device once (the card unless ``device="cpu"`` is
passed) and returns a step that moves the batch there, augments it when
``cfg.augment`` asks and the step trains, runs the family's loss forward and,
for training, the backward and the optimizer update. Steps run
eagerly; the model and optimizer live in the ``TrainState`` and update in
place.
"""

from __future__ import annotations

import torch

from mmdyn_tpu_torch.problems.base import ProblemConfig
from mmdyn_tpu_torch.problems.specs import evaluate, parse_batch
from mmdyn_tpu_torch.problems.transforms import augment_batch
from mmdyn_tpu_torch.utils.device import resolve_device


def _to_device(batch, device):
    """numpy arrays or tensors -> float32 tensors on ``device`` (no copy for
    a tensor already there)."""
    return {k: None if v is None else torch.as_tensor(v, dtype=torch.float32,
                                                      device=device)
            for k, v in batch.items()}


def _loss_fn(model, cfg, batch, generator, kl_weight, train=False):
    if train and cfg.augment:
        # train-time only; its draws come from the generator before the model's
        batch = augment_batch(batch, generator, max_shift=cfg.augment_shift,
                              brightness=cfg.augment_brightness)
    inputs, targets = parse_batch(cfg, batch)
    return evaluate(cfg, model, generator, inputs, targets, kl_weight)


def make_train_step(cfg: ProblemConfig, device=None):
    """Returns (state, batch, generator, kl_weight) -> (state, metrics).

    ``generator`` is a ``torch.Generator`` on the device (dropout and
    reparameterisation noise); ``kl_weight`` a float or 0-dim tensor (the KL
    annealing weight, problems.py:212-216). A float is used as it is: making
    a device tensor of it would copy from the host and wait for the device
    every step. Metrics are detached device tensors; reading them is the
    caller's sync.
    """
    device = resolve_device(device)

    def train_step(state, batch, generator, kl_weight):
        batch = _to_device(batch, device)
        if torch.is_tensor(kl_weight):
            kl_weight = kl_weight.to(device=device, dtype=torch.float32)
        state.optimizer.zero_grad(set_to_none=True)
        loss, aux = _loss_fn(state.model, cfg, batch, generator, kl_weight, True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach(), **aux["perf_measure"]}

    return train_step


def make_eval_step(cfg: ProblemConfig, device=None):
    """Returns (model, batch, generator, kl_weight) -> (metrics, aux).

    Mirrors _test_epoch (problems.py:173-191): batch-statistics BatchNorm and
    active dropout, as in training, but no gradients.
    """
    device = resolve_device(device)

    @torch.no_grad()
    def eval_step(model, batch, generator, kl_weight):
        batch = _to_device(batch, device)
        loss, aux = _loss_fn(model, cfg, batch, generator, kl_weight)
        return {"loss": loss, **aux["perf_measure"]}, aux

    return eval_step


def make_sample_fn(cfg: ProblemConfig, n: int = 50, device=None):
    """Prior sampling for latent-space logging (problems.py:548-559): draws
    z ~ N(0, I) (n samples) and decodes, with an optional condition for a
    conditional model; the sigmoid is for visualisation only
    (problems.py:616-626). Returns (model, generator, condition=None) ->
    ``{"visual", "tactile"}`` images for the MVAE, ``{input_type: ...}`` for
    a VAE; None for regression."""
    if cfg.problem_type == "regression":
        return None
    device = resolve_device(device)

    @torch.no_grad()
    def sample(model, generator, condition=None):
        z = torch.randn((n, cfg.latent_size), generator=generator, device=device)
        if condition is not None:
            condition = torch.as_tensor(condition, dtype=torch.float32, device=device)
        if cfg.is_mvae and cfg.cross_modal:
            vis, tac = model.inference(z, condition)
            return {"visual": torch.sigmoid(vis), "tactile": torch.sigmoid(tac)}
        return {cfg.input_type: torch.sigmoid(model.inference(z, condition))}

    return sample
