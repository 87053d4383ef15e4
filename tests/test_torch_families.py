"""Port parity: the VAE (cnn and mlp), the regressor and the conditional and
dyn_modeling MVAE against the JAX package.

Each case builds the family on both sides from one config (the JAX side
through the training loop's ``_build_model``, the port's through
``model_kwargs``), carries the flax weights into
the port with ``params_from_jax``, and runs the same numpy inputs through
both with dropout off. The VAE's reparameterisation noise is one numpy
tensor handed to both sides; the MVAE runs noise-free.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmdyn_tpu.models import count_parameters as jax_count_parameters
from mmdyn_tpu.models import vae as jax_vae
from mmdyn_tpu.problems import ProblemConfig as JaxConfig
from mmdyn_tpu.problems import make_optimizer as jax_make_optimizer
from mmdyn_tpu.problems import parse_batch as jax_parse_batch
from mmdyn_tpu.problems import reconstruction as jax_recon
from mmdyn_tpu.problems import transforms as jt
from mmdyn_tpu.train import create_train_state as jax_create_train_state
from mmdyn_tpu.train import loop as jax_loop
from mmdyn_tpu.train import make_train_step as jax_make_train_step

from mmdyn_tpu_torch.models import count_parameters, model_kwargs, setup_model
from mmdyn_tpu_torch.models import vae as torch_vae
from mmdyn_tpu_torch.problems import ProblemConfig, make_optimizer, parse_batch
from mmdyn_tpu_torch.problems import reconstruction as torch_recon
from mmdyn_tpu_torch.problems import transforms as tt
from mmdyn_tpu_torch.train import (create_train_state, make_eval_step,
                                   make_sample_fn, make_train_step)
from mmdyn_tpu_torch.utils.weights import params_from_jax
from tests.torch_threads import one_torch_thread  # noqa: F401

LATENT, B, T, S, N_CLASSES = 16, 4, 3, 3, 5
TOL = dict(rtol=1e-4, atol=1e-5)

CFGS = {
    "cnn-vae": dict(problem_type="seq_modeling", model_name="cnn-vae",
                    input_type="visual"),
    "cnn-vae-cond-mask": dict(problem_type="seq_modeling", model_name="cnn-vae",
                              input_type="visual", conditional=True,
                              condition_dim=S, mask_loss=True),
    "cnn-vae-categorical": dict(problem_type="reconstruction", model_name="cnn-vae",
                                input_type="tactile", conditional=True,
                                categorical_conditions=True, condition_dim=N_CLASSES),
    "mlp-vae": dict(problem_type="reconstruction", model_name="mlp-vae",
                    input_type="tactile"),
    "mlp-vae-dyn-mask": dict(problem_type="dyn_modeling", model_name="mlp-vae",
                             input_type="visual", mask_loss=True),
    "regressor": dict(problem_type="regression", model_name="regressor",
                      input_type="visual"),
    "regressor-cond": dict(problem_type="regression", model_name="regressor",
                           input_type="tactile", conditional=True, condition_dim=S),
    "cnn-mvae-dyn": dict(problem_type="dyn_modeling", model_name="cnn-mvae",
                         input_type="visuotactile", use_pose=True, mask_loss=True,
                         noise_free=True, pose_multiplier=50.0),
    "cnn-mvae-cond": dict(problem_type="seq_modeling", model_name="cnn-mvae",
                          input_type="visuotactile", conditional=True,
                          condition_dim=S, noise_free=True),
    "cnn-mvae-categorical": dict(problem_type="seq_modeling", model_name="cnn-mvae",
                                 input_type="visuotactile", use_pose=True,
                                 conditional=True, categorical_conditions=True,
                                 condition_dim=N_CLASSES, noise_free=True),
}
VAES = ["cnn-vae", "cnn-vae-cond-mask", "cnn-vae-categorical", "mlp-vae",
        "mlp-vae-dyn-mask"]
REGRESSORS = ["regressor", "regressor-cond"]


def _configs(name, **extra):
    kw = dict(CFGS[name], latent_size=LATENT, batchsize=B, **extra)
    return JaxConfig(**kw), ProblemConfig(**kw)


def _batch(cfg, seed=0):
    """A numpy (B, T, ...) batch; the shock is (B, T, S) floats, or one class
    id per frame (as float32, as a loader hands it over) when categorical."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.uniform(size=s).astype(np.float32)  # noqa: E731
    batch = {
        "visual": f(B, T, 64, 64, 3), "tactile": f(B, T, 64, 64, 3),
        "pose": f(B, T, 7), "avail": np.ones((B, T, 2), np.float32),
        "final_visual": f(B, 64, 64, 3), "final_tactile": f(B, 64, 64, 3),
        "final_pose": f(B, 7),
        "seg": (rng.uniform(size=(B, T, 64, 64, 3)) > 0.2).astype(np.float32),
    }
    if cfg.categorical_conditions:
        batch["shock"] = rng.integers(0, N_CLASSES, size=(B, T, 1)).astype(np.float32)
    else:
        batch["shock"] = rng.normal(size=(B, T, S)).astype(np.float32)
    return batch


def _pair(cfg_j, seed=0):
    """(flax model, its variables, the port's model with the same weights).
    The JAX side is built by the training loop's own ``_build_model``, the
    port's from ``model_kwargs``: the two derivations are held together."""
    model = jax_loop.Problem._build_model(SimpleNamespace(cfg=cfg_j)).clone(
        dropout_rate=0.0)
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    rngs = {"params": ks[0], "dropout": ks[1], "reparam": ks[2]}
    img = jnp.zeros((2, 64, 64, 3))
    cond = None
    if cfg_j.conditional:
        rows = 6 if cfg_j.model_name == "mlp-vae" else 2   # 3 channel planes per image
        cond = (jnp.zeros((rows,)) if cfg_j.categorical_conditions
                else jnp.zeros((rows, cfg_j.condition_dim)))
    if cfg_j.is_mvae and cfg_j.cross_modal:
        variables = model.init(rngs, [img, img],
                               jnp.zeros((2, 7)) if cfg_j.use_pose else None, cond)
    else:
        variables = model.init(rngs, img, cond)
    port = setup_model(cfg_j.model_name, cross_modal=cfg_j.cross_modal,
                       device="cpu", dropout_rate=0.0, **model_kwargs(cfg_j))
    port.load_state_dict(params_from_jax(
        cfg_j.model_name, jax.tree_util.tree_map(np.asarray, variables["params"])),
        strict=True)
    return model, variables, port


def _noise(shape):
    return np.random.default_rng(9).normal(size=tuple(shape)).astype(np.float32)


@pytest.fixture
def shared_vae_noise(monkeypatch):
    """Both VAEs reparameterise with one numpy noise tensor of mu's shape."""
    monkeypatch.setattr(jax_vae, "reparametrize", lambda rng, mu, lv:
                        mu + jnp.asarray(_noise(mu.shape)) * jnp.exp(0.5 * lv))
    monkeypatch.setattr(torch_vae, "reparametrize", lambda gen, mu, lv:
                        mu + torch.tensor(_noise(mu.shape)) * torch.exp(0.5 * lv))


def _close(got, want, **tol):
    np.testing.assert_allclose(torch.as_tensor(got).detach().numpy(),
                               np.asarray(want), **(tol or TOL))


def _parsed(cfg_j, cfg, batch):
    jin = jax_parse_batch(cfg_j, {k: jnp.asarray(v) for k, v in batch.items()})
    tin = parse_batch(cfg, {k: torch.tensor(v) for k, v in batch.items()})
    return jin, tin


# --- models -----------------------------------------------------------------

@pytest.mark.parametrize("name", list(CFGS))
def test_count_parameters_match_jax(name):
    cfg_j, _ = _configs(name)
    _, variables, port = _pair(cfg_j)
    assert count_parameters(port) == jax_count_parameters(variables["params"])


@pytest.mark.parametrize("name", ["cnn-vae", "cnn-vae-cond-mask",
                                  "cnn-vae-categorical", "mlp-vae"])
def test_vae_forward_matches_flax(shared_vae_noise, name):
    """The forward (recon, means, log_var), the encoder and ``inference``;
    the mlp VAE folds each image's 3 channel planes into rows."""
    cfg_j, cfg = _configs(name)
    model, variables, port = _pair(cfg_j)
    (jin, _), (tin, _) = _parsed(cfg_j, cfg, _batch(cfg, 1))
    jc = jin["shock"] if cfg.conditional else None
    tc = tin["shock"] if cfg.conditional else None
    want = model.apply(variables, jin["x"], jc,
                       rngs={"dropout": jax.random.PRNGKey(0),
                             "reparam": jax.random.PRNGKey(1)})
    got = port(tin["x"], tc)
    assert got[0].shape == want[0].shape
    for g, w in zip(got, want):
        _close(g, w)
    z = np.random.default_rng(2).normal(size=want[1].shape).astype(np.float32)
    _close(port.inference(torch.tensor(z), tc),
           model.apply(variables, jnp.asarray(z), jc, method=type(model).inference))


@pytest.mark.parametrize("name", REGRESSORS)
def test_regressor_forward_matches_flax(name):
    cfg_j, cfg = _configs(name)
    model, variables, port = _pair(cfg_j)
    (jin, _), (tin, _) = _parsed(cfg_j, cfg, _batch(cfg, 3))
    want = model.apply(variables, jin["x"], jin["shock"] if cfg.conditional else None,
                       rngs={"dropout": jax.random.PRNGKey(0)})
    got = port(tin["x"], tin["shock"] if cfg.conditional else None)
    assert got.shape == want.shape == (B, 7)
    _close(got, want)


def test_regressor_that_is_not_conditional_ignores_a_condition():
    """regressor.py:52-55: a non-conditional regressor ignores a condition."""
    cfg_j, cfg = _configs("regressor")
    _, _, port = _pair(cfg_j)
    x = torch.rand((B, 64, 64, 3), generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(port(x, torch.ones(B, S)), port(x))


# --- losses -----------------------------------------------------------------

@pytest.mark.parametrize("name", VAES)
def test_vae_evaluate_matches_jax(shared_vae_noise, name):
    cfg_j, cfg = _configs(name, kl_weight=0.7)
    model, variables, port = _pair(cfg_j)
    (jin, jtg), (tin, ttg) = _parsed(cfg_j, cfg, _batch(cfg, 4))
    want, aux_j = jax_recon.vae_evaluate(model, variables, jax.random.PRNGKey(1),
                                         jin, jtg, 0.7, cfg_j)
    got, aux = torch_recon.vae_evaluate(port, torch.Generator().manual_seed(1),
                                        tin, ttg, 0.7, cfg)
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-4)
    assert set(aux["perf_measure"]) == set(aux_j["perf_measure"]) == {cfg.input_type}
    assert float(aux["perf_measure"][cfg.input_type]) == pytest.approx(
        float(aux_j["perf_measure"][cfg.input_type]), rel=1e-4)
    _close(aux["recon_x"], aux_j["recon_x"], rtol=1e-4, atol=1e-4)
    for key in ("means", "log_var"):
        _close(aux[key], aux_j[key])


@pytest.mark.parametrize("name", REGRESSORS)
def test_regression_evaluate_matches_jax(name):
    """An MSE sum, not divided by the batch; metrics carry ``outputs``."""
    cfg_j, cfg = _configs(name)
    model, variables, port = _pair(cfg_j)
    (jin, jtg), (tin, ttg) = _parsed(cfg_j, cfg, _batch(cfg, 5))
    want, aux_j = jax_recon.regression_evaluate(model, variables, jax.random.PRNGKey(1),
                                                jin, jtg, 1.0, cfg_j)
    got, aux = torch_recon.regression_evaluate(port, torch.Generator(), tin, ttg,
                                               1.0, cfg)
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-4)
    assert float(aux["perf_measure"]["pose"]) == pytest.approx(
        float(aux_j["perf_measure"]["pose"]), rel=1e-4)
    assert "recon_x" not in aux
    _close(aux["outputs"], aux_j["outputs"])


# --- train steps --------------------------------------------------------------

@pytest.mark.parametrize("name", ["cnn-mvae-dyn", "cnn-vae", "regressor",
                                  "cnn-mvae-cond"])
def test_adam_steps_match_jax(shared_vae_noise, name):
    """Three Adam steps through the JAX package's jitted ``make_train_step``
    and the port's, from the same weights on one batch."""
    cfg_j, cfg = _configs(name)
    model, variables, port = _pair(cfg_j)
    batch = _batch(cfg, 6)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tx = jax_make_optimizer(cfg_j)
    jstate = jax_create_train_state(variables["params"], tx)
    jstep = jax_make_train_step(cfg_j, model, tx)
    state = create_train_state(port, make_optimizer(cfg, port.parameters()))
    step = make_train_step(cfg, device="cpu")
    gen = torch.Generator().manual_seed(1)
    for i in range(3):
        jstate, jm = jstep(jstate, jbatch, jax.random.PRNGKey(i), jnp.float32(1.0))
        state, m = step(state, batch, gen, 1.0)
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4), i
        assert set(m) == set(jm)
    assert state.step == 3 == int(jstate.step)


@pytest.mark.parametrize("name", ["cnn-vae-cond-mask", "mlp-vae"])
def test_sample_fn_matches_flax_inference(name):
    """``make_sample_fn`` of a VAE decodes the generator's z (with the
    condition, when conditional) under ``{input_type: sigmoid(logits)}``."""
    cfg_j, cfg = _configs(name)
    model, variables, port = _pair(cfg_j)
    n = 3
    cond = (np.random.default_rng(7).uniform(size=(n, S)).astype(np.float32)
            if cfg.conditional else None)
    out = make_sample_fn(cfg, n=n, device="cpu")(
        port, torch.Generator().manual_seed(2), cond)
    assert set(out) == {cfg.input_type}
    z = torch.randn((n, LATENT), generator=torch.Generator().manual_seed(2))
    want = model.apply(variables, jnp.asarray(z.numpy()),
                       None if cond is None else jnp.asarray(cond),
                       method=type(model).inference)
    _close(out[cfg.input_type], jax.nn.sigmoid(want))


def test_regression_has_no_sample_fn():
    assert make_sample_fn(_configs("regressor")[1], device="cpu") is None


# --- augmentation -------------------------------------------------------------

@pytest.mark.parametrize("seed,max_shift,brightness,keys", [
    (0, 4, 0.1, None),
    (1, 2, 0.3, None),
    (2, 4, 0.1, ("visual", "final_visual", "seg", "pose")),
])
def test_augment_batch_matches_jax(seed, max_shift, brightness, keys):
    """The port applies JAX's own draws (transforms.py:72-77) exactly: edge
    padding is a clamp, brightness a multiply and a clip."""
    batch = _batch(_configs("cnn-vae")[0], 10 + seed)
    if keys is not None:
        batch = {k: batch[k] for k in keys}
    key = jax.random.PRNGKey(seed)
    want = jt.augment_batch({k: jnp.asarray(v) for k, v in batch.items()}, key,
                            max_shift=max_shift, brightness=brightness)
    kf, ky, kx, kb = jax.random.split(key, 4)
    draws = (jax.random.bernoulli(kf, 0.5, (B,)),
             jax.random.randint(ky, (B,), -max_shift, max_shift + 1),
             jax.random.randint(kx, (B,), -max_shift, max_shift + 1),
             1.0 + jax.random.uniform(kb, (B,), minval=-brightness, maxval=brightness))
    got = tt.apply_augment({k: torch.tensor(v) for k, v in batch.items()},
                           *(torch.tensor(np.asarray(d)) for d in draws))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), k)
    assert not np.array_equal(got["visual"].numpy(), batch["visual"])


def test_augment_draws_are_seeded_and_in_range():
    a = tt.augment_draws(torch.Generator().manual_seed(3), 64, 2, 0.25)
    b = tt.augment_draws(torch.Generator().manual_seed(3), 64, 2, 0.25)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    flip, dy, dx, scale = a
    assert flip.dtype == torch.bool and 0 < int(flip.sum()) < 64
    for d in (dy, dx):
        assert int(d.min()) == -2 and int(d.max()) == 2
    assert float(scale.min()) >= 0.75 and float(scale.max()) <= 1.25
    batch = {"pose": torch.zeros(2, 3, 7)}
    assert tt.augment_batch(batch, torch.Generator()) is batch


def test_train_step_augments_with_the_generator_draws():
    """With ``augment`` the step's loss is the loss of the batch that
    ``augment_batch`` makes from the same generator, drawn before the model's
    draws; without it, the plain batch's."""
    _, cfg = _configs("cnn-vae", augment=True)
    cfg_plain = ProblemConfig(**dict(CFGS["cnn-vae"], latent_size=LATENT))
    batch = _batch(cfg, 8)
    losses = {}
    for name, c in (("augment", cfg), ("plain", cfg_plain)):
        model = setup_model("cnn-vae", device="cpu", **model_kwargs(c))
        state = create_train_state(model, make_optimizer(c, model.parameters()))
        gen = torch.Generator().manual_seed(4)
        ref = {k: torch.tensor(v) for k, v in batch.items()}
        if name == "augment":
            ref = tt.augment_batch(ref, gen)
        want = make_eval_step(cfg_plain, device="cpu")(model, ref, gen, 1.0)[0]["loss"]
        _, m = make_train_step(c, device="cpu")(
            state, batch, torch.Generator().manual_seed(4), 1.0)
        assert float(m["loss"]) == float(want), name
        losses[name] = float(m["loss"])
    assert losses["augment"] != losses["plain"]
