"""Train / eval / sample steps (port of ``mmdyn_tpu/train/steps.py``).

Each factory resolves its device once (the card unless ``device="cpu"`` is
passed) and returns a step that moves the batch there, augments it when
``cfg.augment`` asks and the step trains, runs the family's loss forward and,
for training, the backward and the optimizer update. Steps run
eagerly; the model and optimizer live in the ``TrainState`` and update in
place. With ``cfg.remat`` the train step keeps no activations of the loss
forward and recomputes them in the backward, as the JAX step's
``jax.checkpoint`` of the whole loss does (``mmdyn_tpu/train/steps.py:37-40``).

Data parallelism (``mesh``, ``parallel/mesh.py``): each rank passes its row
block of the global batch; the loss forward runs inside
``parallel.sharded(mesh)``, so BatchNorm statistics, noise, dropout and the
loss's normalisation are the global batch's. The gradients are then summed
across ranks by one flat all-reduce after the backward, before the optimizer
step, and the metrics are reduced to the global batch's in one more. That,
not ``DistributedDataParallel``, because DDP reduces only what flows from
its wrapper's ``forward``: the MVAE's loss calls the model's encoders and
decoders directly (``problems/reconstruction.py``), and under ``remat`` the
forward runs again inside the backward. A single all-reduce after the
backward holds for any loss and for remat alike; what it gives up is DDP's
overlap of the reduction with the backward. At one rank every collective
still runs (an all-reduce over one rank is exact), so a one-rank group
trains bit for bit as no group does.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from mmdyn_tpu_torch.parallel.mesh import all_reduce_grads, reduce_metrics, sharded
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


def _loss_and_backward(model, cfg, batch, generator, kl_weight, mesh=None):
    """The train loss forward (inside ``sharded(mesh)``) and its backward;
    under ``cfg.remat`` the forward runs in a checkpoint region, recomputed
    in the backward.

    The checkpoint restores only the global generators, not the explicit
    one every draw comes from. So the region starts by setting the
    generator's state to its state on entry: the recompute redraws the
    forward's dropout masks and noise. After the backward the generator is
    set to where the forward left it, as it would be without remat. The
    region also enters ``sharded(mesh)`` itself: on the card the recompute
    runs on autograd's device thread, outside the caller's context."""
    if not cfg.remat:
        with sharded(mesh):
            loss, aux = _loss_fn(model, cfg, batch, generator, kl_weight, True)
        loss.backward()
        return loss, aux
    start = generator.get_state()

    def run():
        generator.set_state(start)
        with sharded(mesh):
            return _loss_fn(model, cfg, batch, generator, kl_weight, True)

    loss, aux = checkpoint(run, use_reentrant=False, preserve_rng_state=False)
    after = generator.get_state()
    loss.backward()
    generator.set_state(after)
    return loss, aux


def _global_metrics(metrics, mesh):
    return metrics if mesh is None else reduce_metrics(mesh, metrics)


def make_train_step(cfg: ProblemConfig, device=None, mesh=None):
    """Returns (state, batch, generator, kl_weight) -> (state, metrics).

    ``generator`` is a ``torch.Generator`` on the device (dropout and
    reparameterisation noise); ``kl_weight`` a float or 0-dim tensor (the KL
    annealing weight, problems.py:212-216). A float is used as it is: making
    a device tensor of it would copy from the host and wait for the device
    every step. Metrics are detached device tensors; reading them is the
    caller's sync. With ``mesh`` the batch is this rank's row block, the
    device ``mesh.device``, and the metrics are the global batch's.
    """
    device = mesh.device if mesh is not None else resolve_device(device)

    def train_step(state, batch, generator, kl_weight):
        batch = _to_device(batch, device)
        if torch.is_tensor(kl_weight):
            kl_weight = kl_weight.to(device=device, dtype=torch.float32)
        state.optimizer.zero_grad(set_to_none=True)
        loss, aux = _loss_and_backward(state.model, cfg, batch, generator, kl_weight,
                                       mesh)
        if mesh is not None:
            all_reduce_grads(mesh, state.model.parameters())
        state.optimizer.step()
        state.step += 1
        return state, _global_metrics({"loss": loss.detach(), **aux["perf_measure"]}, mesh)

    return train_step


def make_eval_step(cfg: ProblemConfig, device=None, mesh=None):
    """Returns (model, batch, generator, kl_weight) -> (metrics, aux).

    Mirrors _test_epoch (problems.py:173-191): batch-statistics BatchNorm and
    active dropout, as in training, but no gradients. With ``mesh`` as in
    ``make_train_step``; ``aux`` holds this rank's rows.
    """
    device = mesh.device if mesh is not None else resolve_device(device)

    @torch.no_grad()
    def eval_step(model, batch, generator, kl_weight):
        batch = _to_device(batch, device)
        with sharded(mesh):
            loss, aux = _loss_fn(model, cfg, batch, generator, kl_weight)
        return _global_metrics({"loss": loss, **aux["perf_measure"]}, mesh), aux

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
