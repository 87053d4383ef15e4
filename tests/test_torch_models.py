"""Port parity: ``mmdyn_tpu_torch.models`` against ``mmdyn_tpu.models``.

The flax MVAE, unconditional and conditional (float or categorical
condition), is initialised from a seed, its parameters carried into the port
by ``params_from_jax``, and the same numpy inputs go through both (dropout
off, train-mode BatchNorm). The other families' parity tests are in
``test_torch_families.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmdyn_tpu.models import MVAE as JaxMVAE
from mmdyn_tpu.models import count_parameters as jax_count_parameters
from mmdyn_tpu.models import vae as jax_vae
from mmdyn_tpu.models.layers import TrainBatchNorm as JaxBN

from mmdyn_tpu_torch.models import Regressor, count_parameters, setup_model
from mmdyn_tpu_torch.models import vae as torch_vae
from mmdyn_tpu_torch.models.layers import train_batch_norm
from mmdyn_tpu_torch.utils.weights import params_from_jax

LATENT, B = 16, 4
COND_DIM, N_CLASSES = 3, 5
TOL = dict(rtol=1e-4, atol=1e-5)


def _rngs(seed=0):
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    return {"params": ks[0], "dropout": ks[1], "reparam": ks[2]}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    xv = rng.uniform(size=(B, 64, 64, 3)).astype(np.float32)
    xt = rng.uniform(size=(B, 64, 64, 3)).astype(np.float32)
    xp = rng.normal(size=(B, 7)).astype(np.float32)
    return xv, xt, xp


@pytest.fixture(scope="module", params=[False, True], ids=["no_pose", "pose"])
def pair(request):
    """(use_pose, flax model, flax variables, port model with the same weights)."""
    use_pose = request.param
    model = JaxMVAE(latent_size=LATENT, use_pose=use_pose, dropout_rate=0.0)
    xv, xt, xp = _inputs()
    variables = model.init(_rngs(), [jnp.asarray(xv), jnp.asarray(xt)],
                           jnp.asarray(xp) if use_pose else None)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    port = setup_model("cnn-mvae", cross_modal=True, device="cpu",
                       latent_size=LATENT, use_pose=use_pose, dropout_rate=0.0)
    port.load_state_dict(params_from_jax("cnn-mvae", params), strict=True)
    return use_pose, model, variables, port


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _assert_no_pose_pathway(variables, port):
    for name in ("pose_encoder", "pose_decoder"):
        assert name not in variables["params"] and not hasattr(port, name)


def test_parameter_counts_equal(pair):
    use_pose, _, variables, port = pair
    assert count_parameters(port) == jax_count_parameters(variables["params"])


@pytest.mark.parametrize("modality", ["visual", "tactile", "pose"])
def test_encoders_match_flax(pair, modality):
    use_pose, model, variables, port = pair
    if modality == "pose" and not use_pose:
        _assert_no_pose_pathway(variables, port)
        return
    xv, xt, xp = _inputs(1)
    x = {"visual": xv, "tactile": xt, "pose": xp}[modality]
    method = getattr(JaxMVAE, f"encode_{modality}")
    want = model.apply(variables, jnp.asarray(x), method=method,
                       rngs={"dropout": jax.random.PRNGKey(0)})
    got = getattr(port, f"encode_{modality}")(torch.tensor(x))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("modality", ["visual", "tactile", "pose"])
@pytest.mark.parametrize("subsets", [0, 3], ids=["batch", "subset_axis"])
def test_decoders_match_flax(pair, modality, subsets):
    """(B, D) and (K, B, D) latents; the JAX side vmaps over K, so BatchNorm
    statistics are per subset."""
    use_pose, model, variables, port = pair
    if modality == "pose" and not use_pose:
        _assert_no_pose_pathway(variables, port)
        return
    shape = ((subsets,) if subsets else ()) + (B, LATENT)
    z = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    method = getattr(JaxMVAE, f"decode_{modality}")

    def dec(zz):
        return model.apply(variables, zz, method=method)

    want = jax.vmap(dec)(jnp.asarray(z)) if subsets else dec(jnp.asarray(z))
    got = getattr(port, f"decode_{modality}")(torch.tensor(z))
    assert got.shape == want.shape
    _close(got, want)


def test_per_subset_batch_norm_differs_from_folded(pair):
    """Folding the K subsets into one batch mixes their BatchNorm statistics
    and gives other logits; the port's per-subset decode matches JAX's vmap."""
    _, model, variables, port = pair
    rng = np.random.default_rng(3)
    # subsets with different latent scales, as the PoE posteriors have
    z = (rng.normal(size=(3, B, LATENT)) * np.array([0.2, 1.0, 3.0])[:, None, None]
         ).astype(np.float32)
    want = jax.vmap(lambda zz: model.apply(variables, zz,
                                           method=JaxMVAE.decode_visual))(jnp.asarray(z))
    per_subset = port.decode_visual(torch.tensor(z))
    folded = port.decode_visual(torch.tensor(z).reshape(3 * B, LATENT)).reshape(per_subset.shape)
    _close(per_subset, want)
    assert not np.allclose(folded.detach().numpy(), np.asarray(want), **TOL)


def test_joint_forward_and_inference_match_flax(pair, monkeypatch):
    """The reference-parity joint forward with the posterior mean as z."""
    use_pose, model, variables, port = pair
    monkeypatch.setattr(jax_vae, "reparametrize", lambda rng, mu, lv: mu)
    monkeypatch.setattr(torch_vae, "reparametrize", lambda gen, mu, lv: mu)
    xv, xt, xp = _inputs(4)
    want = model.apply(variables, [jnp.asarray(xv), jnp.asarray(xt)],
                       jnp.asarray(xp) if use_pose else None, rngs=_rngs(1))
    got = port((torch.tensor(xv), torch.tensor(xt)),
               torch.tensor(xp) if use_pose else None)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            _close(g, w)
    z = np.random.default_rng(5).normal(size=(B, LATENT)).astype(np.float32)
    want = model.apply(variables, jnp.asarray(z), method=JaxMVAE.inference)
    for g, w in zip(port.inference(torch.tensor(z)), want):
        _close(g, w)


@pytest.mark.parametrize("groups", [1, 3])
def test_train_batch_norm_matches_flax(groups):
    rng = np.random.default_rng(6)
    x = rng.normal(loc=0.5, size=(groups, 5, 6, 6, 8)).astype(np.float32)  # NHWC
    scale = rng.normal(size=8).astype(np.float32)
    bias = rng.normal(size=8).astype(np.float32)
    bn = JaxBN()
    want = jax.vmap(lambda xx: bn.apply(
        {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}, xx)
    )(jnp.asarray(x))
    xt = torch.tensor(x).reshape(groups * 5, 6, 6, 8).permute(0, 3, 1, 2)
    got = train_batch_norm(xt, torch.tensor(scale), torch.tensor(bias), groups)
    got = got.permute(0, 2, 3, 1).reshape(x.shape)
    _close(got, want)


def test_setup_model_seeds_weights_and_torch_default_bounds():
    kw = dict(cross_modal=True, device="cpu", latent_size=LATENT, use_pose=True)
    a, b, c = (setup_model("cnn-mvae", seed=s, **kw) for s in (0, 0, 1))
    for (name, p), q, r in zip(a.state_dict().items(), b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(p, q), name
        if p.dim() > 1:
            assert not torch.equal(p, r), name
            bound = 1.0 / np.sqrt(p.shape[1] * int(np.prod(p.shape[2:])))
            assert float(p.abs().max()) <= bound, name
    bn = a.visual_encoder.conv_net[3]
    assert torch.equal(bn.weight, torch.ones(64)) and torch.equal(bn.bias, torch.zeros(64))


def test_setup_model_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        setup_model("cnn-mvae", cross_modal=True, latent_size=LATENT)


@pytest.mark.parametrize("name,kwargs", [
    ("cnn-vae", {"compute_dtype": "bfloat16"}),
    ("regressor", {"compute_dtype": "bfloat16_full"}),
    ("cnn-mvae", {"conditional": True, "condition_dim": 3, "compute_dtype": "bfloat16"}),
    ("cnn-mvae", {"compute_dtype": "bfloat16_full"}),
    ("mlp-vae", {"compute_dtype": "bfloat16"}),
])
def test_setup_model_unported_raise(name, kwargs):
    """Every family builds under both bf16 policies with float32 parameters
    (the policies cast operands, not weights); a policy left unresolved
    (``auto``) or unknown raises."""
    kw = dict(kwargs) if name == "regressor" else dict(kwargs, latent_size=LATENT)
    model = setup_model(name, cross_modal=name == "cnn-mvae", device="cpu", **kw)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    for bad in ("auto", "float16"):
        with pytest.raises(ValueError, match="compute_dtype"):
            setup_model(name, cross_modal=name == "cnn-mvae", device="cpu",
                        **dict(kw, compute_dtype=bad))


@pytest.mark.parametrize("name,kwargs,cls", [
    ("cnn-mvae", {"use_pose": True}, torch_vae.MVAE),
    ("cnn-mvae", {"conditional": True, "condition_dim": 3}, torch_vae.MVAE),
    ("cnn-vae", {"architecture": "cnn", "use_pose": True}, torch_vae.VAE),
    ("mlp-vae", {"architecture": "mlp", "input_dim": 64 * 64}, torch_vae.VAE),
    ("regressor", {"out_dim": 7, "conditional": True, "condition_dim": 3}, Regressor),
])
def test_setup_model_builds_every_family(name, kwargs, cls):
    kw = dict(kwargs) if name == "regressor" else dict(kwargs, latent_size=LATENT)
    model = setup_model(name, cross_modal=name == "cnn-mvae", device="cpu", **kw)
    assert type(model) is cls
    if name == "cnn-vae":
        with pytest.raises(ValueError, match="cross modal"):
            setup_model(name, cross_modal=True, device="cpu", latent_size=LATENT)
    with pytest.raises(ValueError, match="condition_dim"):
        setup_model(name, cross_modal=name == "cnn-mvae", device="cpu",
                    **dict(kw, conditional=True, condition_dim=None))


# --- the conditional MVAE ------------------------------------------------------

def _condition(kind, rows, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "categorical":       # one class id per row, as float32
        return rng.integers(0, N_CLASSES, size=(rows, 1)).astype(np.float32)
    return rng.normal(size=(rows, COND_DIM)).astype(np.float32)


@pytest.fixture(scope="module", params=["float", "categorical"])
def cond_pair(request):
    """(kind, flax conditional MVAE, its variables, the port's with its weights)."""
    kind = request.param
    kw = dict(latent_size=LATENT, use_pose=True, dropout_rate=0.0, conditional=True,
              categorical_conditions=kind == "categorical",
              condition_dim=N_CLASSES if kind == "categorical" else COND_DIM)
    model = JaxMVAE(**kw)
    xv, xt, xp = _inputs()
    variables = model.init(_rngs(), [jnp.asarray(xv), jnp.asarray(xt)],
                           jnp.asarray(xp), jnp.asarray(_condition(kind, B)))
    port = setup_model("cnn-mvae", cross_modal=True, device="cpu", **kw)
    port.load_state_dict(params_from_jax(
        "cnn-mvae", jax.tree_util.tree_map(np.asarray, variables["params"])), strict=True)
    return kind, model, variables, port


def test_conditional_parameter_counts_and_pose_pair(cond_pair):
    """The condition widens the image heads and ``upsample``, never the
    unconditional pose pair (vae.py:281-291)."""
    kind, _, variables, port = cond_pair
    assert count_parameters(port) == jax_count_parameters(variables["params"])
    width = N_CLASSES if kind == "categorical" else COND_DIM
    assert port.visual_encoder.linear_means.in_features == 512 + width
    assert port.tactile_decoder.upsample[0].in_features == LATENT + width
    assert port.pose_encoder.linear_means.in_features == 512
    assert port.pose_decoder.deconv_net[0].in_features == LATENT


@pytest.mark.parametrize("modality", ["visual", "tactile"])
def test_conditional_encoders_match_flax(cond_pair, modality):
    kind, model, variables, port = cond_pair
    x = _inputs(1)[0 if modality == "visual" else 1]
    c = _condition(kind, B, 1)
    want = model.apply(variables, jnp.asarray(x), jnp.asarray(c),
                       method=getattr(JaxMVAE, f"encode_{modality}"),
                       rngs={"dropout": jax.random.PRNGKey(0)})
    got = getattr(port, f"encode_{modality}")(torch.tensor(x), torch.tensor(c))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("modality", ["visual", "tactile"])
@pytest.mark.parametrize("subsets", [0, 3], ids=["batch", "subset_axis"])
def test_conditional_decoders_match_flax(cond_pair, modality, subsets):
    """With a subset axis the JAX package vmaps over K with the (B, S)
    condition closed over; the port repeats it for each subset."""
    kind, model, variables, port = cond_pair
    shape = ((subsets,) if subsets else ()) + (B, LATENT)
    z = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    c = jnp.asarray(_condition(kind, B, 2))
    method = getattr(JaxMVAE, f"decode_{modality}")

    def dec(zz):
        return model.apply(variables, zz, c, method=method)

    want = jax.vmap(dec)(jnp.asarray(z)) if subsets else dec(jnp.asarray(z))
    got = getattr(port, f"decode_{modality}")(torch.tensor(z), torch.tensor(np.asarray(c)))
    assert got.shape == want.shape
    _close(got, want)


def test_conditional_joint_forward_and_inference_match_flax(cond_pair, monkeypatch):
    kind, model, variables, port = cond_pair
    monkeypatch.setattr(jax_vae, "reparametrize", lambda rng, mu, lv: mu)
    monkeypatch.setattr(torch_vae, "reparametrize", lambda gen, mu, lv: mu)
    xv, xt, xp = _inputs(4)
    c = _condition(kind, B, 4)
    want = model.apply(variables, [jnp.asarray(xv), jnp.asarray(xt)], jnp.asarray(xp),
                       jnp.asarray(c), rngs=_rngs(1))
    got = port((torch.tensor(xv), torch.tensor(xt)), torch.tensor(xp), torch.tensor(c))
    for g, w in zip(got, want):
        _close(g, w)
    z = np.random.default_rng(5).normal(size=(B, LATENT)).astype(np.float32)
    want = model.apply(variables, jnp.asarray(z), jnp.asarray(c), method=JaxMVAE.inference)
    for g, w in zip(port.inference(torch.tensor(z), torch.tensor(c)), want):
        _close(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int64])
def test_idx2onehot_matches_jax(dtype):
    """Class ids compare with 0..n-1 as in ``jax.nn.one_hot``: float ids
    work, and an id outside [0, n) gives a row of zeros."""
    ids = np.array([[0], [3], [4], [7], [-1]])
    want = jax_vae.idx2onehot(jnp.asarray(ids, jnp.int32), N_CLASSES)
    got = torch_vae.idx2onehot(torch.tensor(ids, dtype=dtype), N_CLASSES)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
