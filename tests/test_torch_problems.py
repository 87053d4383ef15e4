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


@pytest.mark.parametrize("problem_type", ["dyn_modeling", "reconstruction", "regression"])
def test_unported_problem_types_raise(problem_type):
    cfg = ProblemConfig(problem_type=problem_type, input_type="visuotactile")
    with pytest.raises(NotImplementedError):
        parse_batch(cfg, {k: torch.tensor(v) for k, v in _batch().items()})


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
