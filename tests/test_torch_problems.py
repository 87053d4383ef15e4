"""Port parity: ``mmdyn_tpu_torch.problems`` against ``mmdyn_tpu.problems``.

The subset-ELBO runs on both sides from the same flax weights (carried over
by ``params_from_jax``), with dropout off and either noise-free posteriors or
one numpy noise tensor handed to both fused PoE calls.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmdyn_tpu.models import MVAE as JaxMVAE
from mmdyn_tpu.problems import ProblemConfig as JaxConfig
from mmdyn_tpu.problems import anneal_kl as jax_anneal_kl
from mmdyn_tpu.problems import parse_batch as jax_parse_batch
from mmdyn_tpu.problems import reconstruction as jax_recon
from mmdyn_tpu.problems import transforms as jt

from mmdyn_tpu_torch.models import setup_model
from mmdyn_tpu_torch.problems import ProblemConfig, anneal_kl, parse_batch
from mmdyn_tpu_torch.problems import reconstruction as torch_recon
from mmdyn_tpu_torch.problems import transforms as tt
from mmdyn_tpu_torch.utils.weights import params_from_jax
from tests.torch_threads import one_torch_thread  # noqa: F401

LATENT, B, T = 16, 4, 3


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.uniform(size=s).astype(np.float32)  # noqa: E731
    return {
        "visual": f(B, T, 64, 64, 3), "tactile": f(B, T, 64, 64, 3),
        "pose": rng.normal(size=(B, T, 7)).astype(np.float32),
        "avail": np.ones((B, T, 2), np.float32),
        "final_visual": f(B, 64, 64, 3), "final_tactile": f(B, 64, 64, 3),
        "final_pose": rng.normal(size=(B, 7)).astype(np.float32),
        "seg": (rng.uniform(size=(B, T, 64, 64, 3)) > 0.2).astype(np.float32),
    }


# --- transforms and parsing ---------------------------------------------------

@pytest.mark.parametrize("name", ["flatten_seq", "stride_first", "dyn_roll"])
def test_transforms_match_jax(name):
    x = _batch()["pose"]
    want = getattr(jt, name)(jnp.asarray(x))
    np.testing.assert_array_equal(getattr(tt, name)(torch.tensor(x)).numpy(),
                                  np.asarray(want))


def test_dyn_targets_match_jax():
    batch = _batch(1)
    want = jt.dyn_targets(jnp.asarray(batch["visual"]),
                          jnp.asarray(batch["final_visual"]))
    got = tt.dyn_targets(torch.tensor(batch["visual"]),
                         torch.tensor(batch["final_visual"]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("use_pose", [False, True])
def test_parse_seq_modeling_matches_jax(use_pose):
    batch = _batch(2)
    kw = dict(problem_type="seq_modeling", input_type="visuotactile",
              use_pose=use_pose)
    want = jax_parse_batch(JaxConfig(**kw), {k: jnp.asarray(v) for k, v in batch.items()})
    got = parse_batch(ProblemConfig(**kw), {k: torch.tensor(v) for k, v in batch.items()})
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            if w[key] is None:
                assert g[key] is None, key
            else:
                np.testing.assert_array_equal(g[key].numpy(), np.asarray(w[key]), key)


INPUTS = {  # id -> (input_type, use_pose)
    "visual": ("visual", False), "tactile": ("tactile", False),
    "visuotactile": ("visuotactile", False), "visuotactile+pose": ("visuotactile", True),
}


def _parse_both(kw, batch):
    want = jax_parse_batch(JaxConfig(**kw), {k: jnp.asarray(v) for k, v in batch.items()})
    got = parse_batch(ProblemConfig(**kw), {k: torch.tensor(v) for k, v in batch.items()})
    return got, want


@pytest.mark.parametrize("inputs", list(INPUTS))
@pytest.mark.parametrize("problem_type", ["seq_modeling", "dyn_modeling",
                                          "regression", "reconstruction"])
def test_parse_batch_matches_jax(problem_type, inputs):
    """Every problem type x input type, with a shock: the same keys and the
    same values; regression takes one modality, and rejects visuotactile
    input on both sides."""
    input_type, use_pose = INPUTS[inputs]
    batch = dict(_batch(5), shock=np.random.default_rng(6).normal(
        size=(B, T, 3)).astype(np.float32))
    kw = dict(problem_type=problem_type, input_type=input_type, use_pose=use_pose)
    if problem_type == "regression" and input_type == "visuotactile":
        for side in (jax_parse_batch, parse_batch):
            with pytest.raises(ValueError, match="not supported by regression"):
                cfg = (JaxConfig if side is jax_parse_batch else ProblemConfig)(**kw)
                side(cfg, batch)
        return
    got, want = _parse_both(kw, batch)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            if w[key] is None:
                assert g[key] is None, key
            else:
                np.testing.assert_array_equal(g[key].numpy(), np.asarray(w[key]), key)


@pytest.mark.parametrize("problem_type", ["dyn_modeling", "reconstruction", "regression"])
def test_unported_problem_types_raise(problem_type):
    """dyn_modeling, reconstruction and regression take visual or tactile
    input alone (or, but for regression, visuotactile): a pose-only input
    type raises ValueError in the port as in the JAX package."""
    kw = dict(problem_type=problem_type, input_type="pose")
    for make, parse in ((JaxConfig, jax_parse_batch), (ProblemConfig, parse_batch)):
        with pytest.raises(ValueError, match="input_type 'pose' is not supported"):
            parse(make(**kw), _batch())


def test_dyn_pose_targets_roll_without_the_resting_patch():
    """problems.py:798: the image targets of each sequence's last frame are
    its resting frames, its pose target is the next sequence's first pose."""
    batch = {k: torch.tensor(v) for k, v in _batch(7).items()}
    cfg = ProblemConfig(problem_type="dyn_modeling", input_type="visuotactile",
                        use_pose=True)
    inputs, targets = parse_batch(cfg, batch)
    assert inputs["visual"].shape == (B * T, 64, 64, 3)
    torch.testing.assert_close(targets["visual"][T - 1], batch["final_visual"][0])
    torch.testing.assert_close(targets["pose"][T - 1], batch["pose"][1, 0])
    torch.testing.assert_close(targets["pose"][-1], batch["pose"][0, 0])


def test_config_validation_and_anneal_kl():
    for bad in (dict(problem_type="x"), dict(input_type="x"), dict(optimizer="x"),
                dict(augment=True, use_pose=True)):
        with pytest.raises(ValueError):
            ProblemConfig(**bad)
    assert [f.name for f in dataclasses.fields(ProblemConfig)] == \
        [f.name for f in dataclasses.fields(JaxConfig)]
    for epoch in (0, 7, 49, 50, 80):
        assert anneal_kl(epoch, 50) == jax_anneal_kl(epoch, 50)


# --- the subset-ELBO --------------------------------------------------------

CASES = [  # (use_pose, noise, mask_loss)
    (False, "free", False),
    (True, "free", False),
    (False, "shared", True),
    (True, "shared", False),
]


@pytest.mark.parametrize("use_pose,noise,mask_loss", CASES)
def test_mvae_evaluate_matches_jax(monkeypatch, use_pose, noise, mask_loss):
    kw = dict(problem_type="seq_modeling", model_name="cnn-mvae",
              input_type="visuotactile", use_pose=use_pose, mask_loss=mask_loss,
              kl_weight=0.7, pose_multiplier=50.0, latent_size=LATENT,
              noise_free=noise == "free")
    batch = _batch(3)
    model = JaxMVAE(latent_size=LATENT, use_pose=use_pose, dropout_rate=0.0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = model.init(jax.random.PRNGKey(0), [jbatch["visual"][:, 0]] * 2,
                           jbatch["pose"][:, 0] if use_pose else None)
    port = setup_model("cnn-mvae", cross_modal=True, device="cpu",
                       latent_size=LATENT, use_pose=use_pose, dropout_rate=0.0)
    port.load_state_dict(params_from_jax(
        "cnn-mvae", jax.tree_util.tree_map(np.asarray, variables["params"])))

    if noise == "shared":
        k = 7 if use_pose else 3
        shared = np.random.default_rng(4).normal(size=(k, B, LATENT)).astype(np.float32)
        real_j, real_t = jax_recon.fused_poe_reparam, torch_recon.fused_poe_reparam
        monkeypatch.setattr(jax_recon, "fused_poe_reparam",
                            lambda mu, lv, m, n: real_j(mu, lv, m, jnp.asarray(shared)))
        monkeypatch.setattr(torch_recon, "fused_poe_reparam",
                            lambda mu, lv, m, n: real_t(mu, lv, m, torch.tensor(shared)))

    cfg_j = JaxConfig(**kw)
    want, aux_j = jax_recon.mvae_evaluate(
        model, variables, jax.random.PRNGKey(1), *jax_parse_batch(cfg_j, jbatch),
        kl_weight=0.7, cfg=cfg_j)
    cfg = ProblemConfig(**kw)
    got, aux = torch_recon.mvae_evaluate(
        port, torch.Generator().manual_seed(1),
        *parse_batch(cfg, {k: torch.tensor(v) for k, v in batch.items()}),
        kl_weight=0.7, cfg=cfg)

    assert float(got.detach()) == pytest.approx(float(want), rel=1e-4)
    for key in aux_j["perf_measure"]:
        assert float(aux["perf_measure"][key]) == pytest.approx(
            float(aux_j["perf_measure"][key]), rel=1e-4)
    for key in aux_j["recon_x"]:
        np.testing.assert_allclose(aux["recon_x"][key].numpy(),
                                   np.asarray(aux_j["recon_x"][key]),
                                   rtol=1e-4, atol=1e-4)
    for key in ("means", "log_var"):
        np.testing.assert_allclose(aux[key].numpy(), np.asarray(aux_j[key]),
                                   rtol=1e-4, atol=1e-5)


DYN_COND_CASES = {  # id -> config fields beyond the shared ones
    "dyn_pose_mask": dict(problem_type="dyn_modeling", use_pose=True, mask_loss=True),
    "dyn_no_pose": dict(problem_type="dyn_modeling"),
    "conditional": dict(conditional=True, condition_dim=3, use_pose=True),
    "conditional_categorical": dict(conditional=True, categorical_conditions=True,
                                    condition_dim=5, mask_loss=True),
}


@pytest.mark.parametrize("noise", ["free", "shared"])
@pytest.mark.parametrize("case", list(DYN_COND_CASES))
def test_mvae_evaluate_dyn_and_conditional_match_jax(monkeypatch, case, noise):
    """dyn_modeling (B*T rows, divided by B*T) and the conditional MVAE, whose
    condition reaches both image encoders and decoders but not the pose
    pair (reconstruction.py:138, 149-152, 184-187)."""
    extra = DYN_COND_CASES[case]
    kw = dict(dict(problem_type="seq_modeling", model_name="cnn-mvae",
                   input_type="visuotactile", kl_weight=0.7, pose_multiplier=50.0,
                   latent_size=LATENT, noise_free=noise == "free"), **extra)
    rng = np.random.default_rng(8)
    batch = _batch(3)
    if kw.get("categorical_conditions"):
        batch["shock"] = rng.integers(0, 5, size=(B, T, 1)).astype(np.float32)
    else:
        batch["shock"] = rng.normal(size=(B, T, 3)).astype(np.float32)
    cfg_j, cfg = JaxConfig(**kw), ProblemConfig(**kw)
    mkw = dict(latent_size=LATENT, use_pose=cfg.use_pose, dropout_rate=0.0,
               conditional=cfg.conditional,
               categorical_conditions=cfg.categorical_conditions,
               condition_dim=cfg.condition_dim)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jin, jtg = jax_parse_batch(cfg_j, jbatch)
    model = JaxMVAE(**mkw)
    variables = model.init(jax.random.PRNGKey(0), [jin["visual"]] * 2, jin.get("pose"),
                           jin["shock"] if cfg.conditional else None)
    port = setup_model("cnn-mvae", cross_modal=True, device="cpu", **mkw)
    port.load_state_dict(params_from_jax(
        "cnn-mvae", jax.tree_util.tree_map(np.asarray, variables["params"])))
    rows = jin["visual"].shape[0]
    assert rows == (B * T if cfg.problem_type == "dyn_modeling" else B)

    if noise == "shared":
        k = 7 if cfg.use_pose else 3
        shared = np.random.default_rng(4).normal(size=(k, rows, LATENT)).astype(np.float32)
        real_j, real_t = jax_recon.fused_poe_reparam, torch_recon.fused_poe_reparam
        monkeypatch.setattr(jax_recon, "fused_poe_reparam",
                            lambda mu, lv, m, n: real_j(mu, lv, m, jnp.asarray(shared)))
        monkeypatch.setattr(torch_recon, "fused_poe_reparam",
                            lambda mu, lv, m, n: real_t(mu, lv, m, torch.tensor(shared)))

    want, aux_j = jax_recon.mvae_evaluate(model, variables, jax.random.PRNGKey(1),
                                          jin, jtg, kl_weight=0.7, cfg=cfg_j)
    got, aux = torch_recon.mvae_evaluate(
        port, torch.Generator().manual_seed(1),
        *parse_batch(cfg, {k: torch.tensor(v) for k, v in batch.items()}),
        kl_weight=0.7, cfg=cfg)

    assert float(got.detach()) == pytest.approx(float(want), rel=1e-4)
    assert set(aux["perf_measure"]) == set(aux_j["perf_measure"])
    for key in aux_j["perf_measure"]:
        assert float(aux["perf_measure"][key]) == pytest.approx(
            float(aux_j["perf_measure"][key]), rel=1e-4)
    for key in aux_j["recon_x"]:
        np.testing.assert_allclose(aux["recon_x"][key].numpy(),
                                   np.asarray(aux_j["recon_x"][key]),
                                   rtol=1e-4, atol=1e-4)
    for key in ("means", "log_var"):
        np.testing.assert_allclose(aux[key].numpy(), np.asarray(aux_j[key]),
                                   rtol=1e-4, atol=1e-5)
