"""Port parity: ``mmdyn_tpu_torch.train`` against ``mmdyn_tpu.train``.

Three optimizer steps on one batch from a shared initialisation (flax
weights carried over by ``params_from_jax``), noise-free and without
dropout, through the JAX package's jitted ``make_train_step`` and the port's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from mmdyn_tpu.models import MVAE as JaxMVAE
from mmdyn_tpu.problems import ProblemConfig as JaxConfig
from mmdyn_tpu.problems import make_optimizer as jax_make_optimizer
from mmdyn_tpu.train import create_train_state as jax_create_train_state
from mmdyn_tpu.train import make_train_step as jax_make_train_step
from mmdyn_tpu.train.steps import _loss_fn as jax_loss_fn

from mmdyn_tpu_torch.models import setup_model
from mmdyn_tpu_torch.ops import kernels
from mmdyn_tpu_torch.problems import ProblemConfig, make_optimizer
from mmdyn_tpu_torch.train import (create_train_state, make_eval_step,
                                   make_sample_fn, make_train_step)
from mmdyn_tpu_torch.utils.weights import params_from_jax
from tests.torch_threads import one_torch_thread  # noqa: F401

LATENT, B, T = 16, 4, 2


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.uniform(size=s).astype(np.float32)  # noqa: E731
    return {
        "visual": f(B, T, 64, 64, 3), "tactile": f(B, T, 64, 64, 3),
        "pose": f(B, T, 7), "avail": np.ones((B, T, 2), np.float32),
        "final_visual": f(B, 64, 64, 3), "final_tactile": f(B, 64, 64, 3),
        "final_pose": f(B, 7), "seg": np.ones((B, T, 64, 64, 3), np.float32),
    }


def _cfg_kwargs(use_pose):
    return dict(problem_type="seq_modeling", model_name="cnn-mvae",
                input_type="visuotactile", use_pose=use_pose, latent_size=LATENT,
                batchsize=B, noise_free=True)


def _port(cfg, params=None, seed=0):
    model = setup_model("cnn-mvae", cross_modal=True, device="cpu", seed=seed,
                        latent_size=LATENT, use_pose=cfg.use_pose, dropout_rate=0.0)
    if params is not None:
        model.load_state_dict(params_from_jax("cnn-mvae", params))
    return create_train_state(model, make_optimizer(cfg, model.parameters()))


@pytest.mark.parametrize("use_pose", [False, True])
def test_adam_steps_match_jax(use_pose):
    kw = _cfg_kwargs(use_pose)
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    cfg_j = JaxConfig(**kw)
    model = JaxMVAE(latent_size=LATENT, use_pose=use_pose, dropout_rate=0.0)
    variables = model.init(jax.random.PRNGKey(0), [jbatch["visual"][:, 0]] * 2,
                           jbatch["pose"][:, 0] if use_pose else None)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    # the first step's gradients, mapped to the port's layout
    grads_j = jax.grad(lambda p: jax_loss_fn(p, model, cfg_j, jbatch,
                                             jax.random.PRNGKey(1), 1.0)[0])(
        variables["params"])
    grads_j = params_from_jax("cnn-mvae", jax.tree_util.tree_map(np.asarray, grads_j))

    tx = jax_make_optimizer(cfg_j)
    jstate = jax_create_train_state(variables["params"], tx)
    jstep = jax_make_train_step(cfg_j, model, tx)
    cfg = ProblemConfig(**kw)
    state = _port(cfg, params)
    step = make_train_step(cfg, device="cpu")
    gen = torch.Generator().manual_seed(1)
    for i in range(3):
        jstate, jm = jstep(jstate, jbatch, jax.random.PRNGKey(i), jnp.float32(1.0))
        state, m = step(state, batch, gen, 1.0)
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4), i
        if i == 0:
            for name, p in state.model.named_parameters():
                want = grads_j[name].numpy()
                np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-3,
                                           atol=1e-5 * np.abs(want).max(), err_msg=name)
    assert state.step == 3 == int(jstate.step)


@pytest.mark.parametrize("name", ["Adam", "SGD"])
def test_make_optimizer_matches_optax(name):
    """torch SGD(momentum 0.9, weight decay 5e-4) and Adam == the optax
    chains of the JAX package, over a few steps of a quadratic."""
    cfg = ProblemConfig(optimizer=name, lr=0.05)
    tx = jax_make_optimizer(JaxConfig(optimizer=name, lr=0.05))
    w0 = np.random.default_rng(0).normal(size=(5,)).astype(np.float32)
    p = torch.nn.Parameter(torch.tensor(w0))
    opt = make_optimizer(cfg, [p])
    jp = jnp.asarray(w0)
    opt_state = tx.init(jp)
    for _ in range(4):
        opt.zero_grad()
        (p ** 4).sum().backward()
        opt.step()
        updates, opt_state = tx.update(4 * jp ** 3, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
    # the two libraries order their float32 update arithmetic differently:
    # about 1e-6 absolute after four steps of lr 0.05
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=1e-5, atol=2e-6)


def test_eval_step_and_sample_fn():
    cfg = ProblemConfig(**_cfg_kwargs(True))
    state = _port(cfg)
    batch = _batch(1)
    gen = torch.Generator()
    metrics, aux = make_eval_step(cfg, device="cpu")(state.model, batch, gen, 1.0)
    assert not metrics["loss"].requires_grad
    assert aux["recon_x"]["visual"].shape == (B, 64, 64, 3)
    # eval changes nothing: a train step from here reports the same loss
    _, m = make_train_step(cfg, device="cpu")(state, batch, gen, 1.0)
    assert float(m["loss"]) == pytest.approx(float(metrics["loss"]), rel=1e-6)

    sample = make_sample_fn(cfg, n=3, device="cpu")
    out = sample(state.model, torch.Generator().manual_seed(2))
    z = torch.randn((3, LATENT), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        vis, tac = state.model.inference(z)
    torch.testing.assert_close(out["visual"], torch.sigmoid(vis))
    torch.testing.assert_close(out["tactile"], torch.sigmoid(tac))
    assert out["visual"].shape == (3, 64, 64, 3)


def test_dropout_and_noise_come_from_the_generator():
    """With dropout and reparameterisation noise on, one generator seed gives
    one loss, and another seed another."""
    cfg = ProblemConfig(**dict(_cfg_kwargs(False), noise_free=False))
    batch = _batch(2)

    def loss(seed):
        model = setup_model("cnn-mvae", cross_modal=True, device="cpu",
                            latent_size=LATENT)
        return float(make_eval_step(cfg, device="cpu")(
            model, batch, torch.Generator().manual_seed(seed), 1.0)[0]["loss"])

    assert loss(3) == loss(3) != loss(4)


def test_cpu_train_step_launches_no_kernel(monkeypatch):
    monkeypatch.setattr(kernels.fused_poe_reparam, "launches", 0)
    monkeypatch.setattr(kernels.fused_masked_bce_sum, "launches", 0)
    cfg = ProblemConfig(**_cfg_kwargs(True))
    state = _port(cfg)
    make_train_step(cfg, device="cpu")(state, _batch(), torch.Generator(), 1.0)
    assert kernels.fused_poe_reparam.launches == kernels.fused_masked_bce_sum.launches == 0


def test_steps_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ProblemConfig(**_cfg_kwargs(False))
    for factory in (make_train_step, make_eval_step, make_sample_fn):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            factory(cfg)
