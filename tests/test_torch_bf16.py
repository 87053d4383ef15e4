"""Port parity of the bf16 activation policies, the bf16-logit BCE, the
``auto`` policy rule and ``remat``.

The flax MVAE under ``bfloat16`` / ``bfloat16_full`` and the port's under the
same policy share weights (``params_from_jax``) and inputs. The two
frameworks round to bf16 at the same layer boundaries but sum in different
orders inside each product, so a bf16 activation may differ by a few units
of its last place (2^-8 relative): modules are held at rel 2e-2 of their
largest output, and losses, which sum many such elements, at rel 2e-3.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmdyn_tpu.models import MVAE as JaxMVAE
from mmdyn_tpu.ops import kernels as jk
from mmdyn_tpu.problems import ProblemConfig as JaxConfig
from mmdyn_tpu.problems.base import select_compute_dtype as jax_select_compute_dtype

from mmdyn_tpu_torch.models import setup_model
from mmdyn_tpu_torch.ops import kernels as tk
from mmdyn_tpu_torch.problems import ProblemConfig, make_optimizer, select_compute_dtype
from mmdyn_tpu_torch.train import create_train_state, make_train_step
from mmdyn_tpu_torch.utils.weights import params_from_jax

LATENT, B, T = 16, 4, 2
BF16 = ["bfloat16", "bfloat16_full"]


def _close(got, want, rel=2e-2):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * np.abs(want).max())


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.uniform(size=s).astype(np.float32)  # noqa: E731
    return {
        "visual": f(B, T, 64, 64, 3), "tactile": f(B, T, 64, 64, 3),
        "pose": f(B, T, 7), "avail": np.ones((B, T, 2), np.float32),
        "final_visual": f(B, 64, 64, 3), "final_tactile": f(B, 64, 64, 3),
        "final_pose": f(B, 7), "seg": np.ones((B, T, 64, 64, 3), np.float32),
    }


@pytest.fixture(scope="module", params=BF16)
def pair(request):
    """(policy, flax MVAE + pose, its variables, the port's with its weights)."""
    dt = request.param
    model = JaxMVAE(latent_size=LATENT, use_pose=True, dropout_rate=0.0, compute_dtype=dt)
    batch = _batch()
    variables = model.init(jax.random.PRNGKey(0),
                           [jnp.asarray(batch["visual"][:, 0])] * 2,
                           jnp.asarray(batch["pose"][:, 0]))
    port = setup_model("cnn-mvae", cross_modal=True, device="cpu", latent_size=LATENT,
                       use_pose=True, dropout_rate=0.0, compute_dtype=dt)
    port.load_state_dict(params_from_jax(
        "cnn-mvae", jax.tree_util.tree_map(np.asarray, variables["params"])), strict=True)
    return dt, model, variables, port


@pytest.mark.parametrize("modality", ["visual", "pose"])
def test_encoders_match_flax(pair, modality):
    """The heads come out float32 under both policies (vae.py:120-122)."""
    dt, model, variables, port = pair
    batch = _batch(1)
    x = batch[modality][:, 0]
    want = model.apply(variables, jnp.asarray(x),
                       method=getattr(JaxMVAE, f"encode_{modality}"))
    got = getattr(port, f"encode_{modality}")(torch.tensor(x))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        _close(g, w)


@pytest.mark.parametrize("modality", ["visual", "pose"])
def test_decoders_match_flax(pair, modality):
    """(K, B, D) latents, per-subset BatchNorm; the CNN logits are bf16 under
    bfloat16_full only, the pose always float32 (vae.py:163-175)."""
    dt, model, variables, port = pair
    z = np.random.default_rng(2).normal(size=(3, B, LATENT)).astype(np.float32)
    method = getattr(JaxMVAE, f"decode_{modality}")
    want = jax.vmap(lambda zz: model.apply(variables, zz, method=method))(jnp.asarray(z))
    got = getattr(port, f"decode_{modality}")(torch.tensor(z))
    bf16_logits = dt == "bfloat16_full" and modality == "visual"
    assert got.dtype == (torch.bfloat16 if bf16_logits else torch.float32)
    assert (want.dtype == jnp.bfloat16) == bf16_logits
    _close(got, want)


def test_joint_forward_matches_flax(pair, monkeypatch):
    from mmdyn_tpu.models import vae as jax_vae
    from mmdyn_tpu_torch.models import vae as torch_vae

    dt, model, variables, port = pair
    monkeypatch.setattr(jax_vae, "reparametrize", lambda rng, mu, lv: mu)
    monkeypatch.setattr(torch_vae, "reparametrize", lambda gen, mu, lv: mu)
    batch = _batch(4)
    xv, xt, xp = batch["visual"][:, 0], batch["tactile"][:, 0], batch["pose"][:, 0]
    want = model.apply(variables, [jnp.asarray(xv), jnp.asarray(xt)], jnp.asarray(xp),
                       rngs={"dropout": jax.random.PRNGKey(1),
                             "reparam": jax.random.PRNGKey(2)})
    got = port((torch.tensor(xv), torch.tensor(xt)), torch.tensor(xp))
    for g, w in zip(got, want):
        _close(g, w)


def test_train_step_matches_jax(pair):
    """One seq_modeling subset-ELBO step: the loss, and the port's loss after
    the Adam update, against the JAX step's (rel 2e-3)."""
    from mmdyn_tpu.problems import make_optimizer as jax_make_optimizer
    from mmdyn_tpu.train import create_train_state as jax_create_train_state
    from mmdyn_tpu.train import make_train_step as jax_make_train_step

    dt, model, variables, port = pair
    kw = dict(problem_type="seq_modeling", model_name="cnn-mvae", input_type="visuotactile",
              use_pose=True, latent_size=LATENT, batchsize=B, noise_free=True,
              compute_dtype=dt)
    batch = _batch(5)
    cfg_j = JaxConfig(**kw)
    tx = jax_make_optimizer(cfg_j)
    jstate = jax_create_train_state(variables["params"], tx)
    jstep = jax_make_train_step(cfg_j, model, tx)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    cfg = ProblemConfig(**kw)
    model_t = setup_model("cnn-mvae", cross_modal=True, device="cpu", latent_size=LATENT,
                          use_pose=True, dropout_rate=0.0, compute_dtype=dt)
    model_t.load_state_dict(port.state_dict())
    state = create_train_state(model_t, make_optimizer(cfg, model_t.parameters()))
    step = make_train_step(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for i in range(2):
        jstate, jm = jstep(jstate, jbatch, jax.random.PRNGKey(i), jnp.float32(1.0))
        state, m = step(state, batch, gen, 1.0)
        assert np.isfinite(float(m["loss"]))
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=2e-3), i


def test_bf16_full_tracks_f32():
    """The port's own bfloat16_full loss: finite, falling, and within 1% of
    its float32 loss after 4 steps (JAX tests/test_train.py:97-124)."""
    finals = {}
    for dt in ("float32", "bfloat16_full"):
        cfg = ProblemConfig(problem_type="seq_modeling", model_name="cnn-vae",
                            input_type="visual", latent_size=LATENT, batchsize=B,
                            compute_dtype=dt)
        model = setup_model("cnn-vae", device="cpu", latent_size=LATENT,
                            architecture="cnn", compute_dtype=dt)
        state = create_train_state(model, make_optimizer(cfg, model.parameters()))
        step = make_train_step(cfg, device="cpu")
        batch = _batch()
        losses = [float(step(state, batch, torch.Generator().manual_seed(i), 0.5)[1]["loss"])
                  for i in range(4)]
        assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
        finals[dt] = losses[-1]
    assert abs(finals["bfloat16_full"] - finals["float32"]) / finals["float32"] < 0.01


# --- the bf16-logit BCE ----------------------------------------------------------

def _bce_bf16_inputs(values, with_mask):
    """(K, B, H, W, C) logits, target and mask (or None). ``normal``: logits
    N(0, 3); ``adversarial``: N(0, 3) with 10% saturated logits, |x| up to 90
    (exp(-|x|) underflows), 20% exact zeros, half the targets 0 or 1, and
    under a mask a fully masked row."""
    rng = np.random.default_rng(11)
    shape = (4, 3, 8, 8, 3)
    if values == "normal":
        logits = rng.normal(size=shape).astype(np.float32) * 3
        target = rng.uniform(size=shape[1:]).astype(np.float32)
    else:
        logits = rng.normal(size=shape) * 3
        saturated = rng.uniform(size=shape) < 0.1
        logits = np.where(saturated, rng.uniform(-90, 90, size=shape), logits)
        logits = (logits * (rng.uniform(size=shape) > 0.2)).astype(np.float32)
        u = rng.uniform(size=(3,) + shape[1:])
        target = np.where(u[0] > 0.5, u[1] > 0.5, u[2]).astype(np.float32)
    mask = (rng.uniform(size=target.shape) > 0.3).astype(np.float32) if with_mask else None
    if mask is not None and values == "adversarial":
        mask[0] = 0.0
    return logits, target, mask


@pytest.mark.parametrize("values", ["normal", "adversarial"])
@pytest.mark.parametrize("with_mask", [False, True])
def test_bce_sum_bf16_logits_match_jax(with_mask, values):
    """bf16 logits, float32 target and mask: the plain version and the
    wrapper against ``_bce_jnp`` on the same bf16 logits (rel 1e-6; both
    upcast before any arithmetic) and against the same sum in float64 (rel
    1e-6: XLA's own float32 sum of the adversarial set lies up to 1.3e-6
    from it over other seeds, the port's under 2e-7), and the backward
    against ``_bce_bwd``: a bf16 cotangent, as the logits."""
    logits, target, mask = _bce_bf16_inputs(values, with_mask)
    jlogits = jnp.asarray(logits, jnp.bfloat16)
    tlogits = torch.tensor(logits).to(torch.bfloat16)
    np.testing.assert_array_equal(np.asarray(jlogits.astype(jnp.float32)),
                                  tlogits.float().numpy())
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.tensor(mask)
    want = jk._bce_jnp(jlogits, jnp.asarray(target), jm)
    x64 = tlogits.double().numpy() * (1.0 if mask is None else mask[None])
    z64 = target.astype(np.float64) * (1.0 if mask is None else mask)
    exact = (np.sum(np.maximum(x64, 0.0) + np.log1p(np.exp(-np.abs(x64))))
             - np.sum(z64 * x64.sum(axis=0)))
    for fn in (tk.bce_sum_plain, tk.fused_masked_bce_sum):
        got = fn(tlogits, torch.tensor(target), tm)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
        np.testing.assert_allclose(float(got), exact, rtol=1e-6)

    g = 0.37
    want_d, _, _ = jk._bce_bwd((jlogits, jnp.asarray(target), jm), jnp.float32(g))
    x = tlogits.clone().requires_grad_(True)
    (g * tk.fused_masked_bce_sum(x, torch.tensor(target), tm)).backward()
    assert x.grad.dtype == torch.bfloat16 and want_d.dtype == jnp.bfloat16
    np.testing.assert_allclose(x.grad.float().numpy(), np.asarray(want_d, np.float32),
                               rtol=2 ** -8, atol=1e-6)


def test_bce_sum_cuda_accepts_bf16_logits_only_besides_f32():
    """The wrapper's checks, before any build: bf16 and float32 logits pass
    (here to a missing device), float16 logits, a bf16 target and more bf16
    rows than the kernel's 7 subsets do not."""
    x = torch.zeros((2, 3, 4), dtype=torch.float16)
    z = torch.zeros((3, 4))
    with pytest.raises(ValueError, match="logits: float32 or bfloat16 expected"):
        tk._bce_sum_cuda(x, z, None)
    with pytest.raises(ValueError, match="target: float32 expected"):
        tk._bce_sum_cuda(x.to(torch.bfloat16), z.to(torch.bfloat16), None)
    with pytest.raises(ValueError, match="bf16 logits: 1 to 7 rows, got 8"):
        tk._bce_sum_cuda(torch.zeros((8, 3, 4), dtype=torch.bfloat16), z, None)


# --- the auto policy -------------------------------------------------------------

def test_select_compute_dtype_matches_jax_rule(monkeypatch):
    """The cases of JAX tests/test_train.py:50-70 (batch sizes and problems
    on both sides of the TPU's 512-row crossover) off the TPU, where the JAX
    rule gives float32, as the port's does on the card and on the CPU;
    explicit policies pass through on both sides."""
    base = dict(model_name="cnn-mvae", input_type="visuotactile")
    cases = [(dict(base, batchsize=128), 8), (dict(base, batchsize=512), 8),
             (dict(base, batchsize=128, problem_type="dyn_modeling"), 8),
             (dict(base, batchsize=64, problem_type="reconstruction"), 4),
             (dict(base, batchsize=511, problem_type="regression",
                   model_name="regressor", input_type="visual"), 8),
             (dict(base, batchsize=4096), 8)]
    for backend in ("cpu", "gpu"):
        monkeypatch.setattr(jax, "default_backend", lambda: backend)
        for kw, seq_len in cases:
            for policy in ("auto", "float32", "bfloat16", "bfloat16_full"):
                want = jax_select_compute_dtype(JaxConfig(compute_dtype=policy, **kw),
                                                seq_len)
                assert want == ("float32" if policy == "auto" else policy)
                got = select_compute_dtype(ProblemConfig(compute_dtype=policy, **kw),
                                           seq_len)
                assert got == want, (backend, kw, policy)


# --- rounding at the layer boundaries ----------------------------------------------

def policy_layer_outputs(cfg, batch):
    """One train step of ``cfg`` on the CPU with every bias set to 0, the
    output of every Linear / Conv2d / ConvTranspose2d read by a forward hook:
    with no bias to add, a product rounded to bf16 is exactly representable
    in bf16 whatever dtype carries it."""
    model = setup_model(cfg.model_name, cross_modal=cfg.cross_modal, device="cpu",
                        latent_size=LATENT, use_pose=True, dropout_rate=0.0,
                        compute_dtype=cfg.compute_dtype)
    layers = [m for m in model.modules()
              if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    outputs = []
    with torch.no_grad():
        for m in layers:
            if m.bias is not None:
                m.bias.zero_()
    for m in layers:
        m.register_forward_hook(lambda mod, args, out: outputs.append(out.detach()))
    state = create_train_state(model, make_optimizer(cfg, model.parameters()))
    make_train_step(cfg, device="cpu")(state, batch, torch.Generator().manual_seed(0), 1.0)
    return len(layers), outputs


@pytest.mark.parametrize("policy", ["float32"] + BF16)
def test_policy_layers_round_to_bf16(policy):
    """Under ``bfloat16`` every conv and Linear output of a seq step is
    float32 holding bf16 values, under ``bfloat16_full`` it is bf16, and
    under ``float32`` none is bf16-representable: a policy that silently ran
    float32 fails here, which a loss tolerance cannot show: the two
    policies' losses sum so many elements that they barely differ."""
    cfg = ProblemConfig(problem_type="seq_modeling", model_name="cnn-mvae",
                        input_type="visuotactile", use_pose=True, latent_size=LATENT,
                        batchsize=B, noise_free=True, compute_dtype=policy)
    n_layers, outputs = policy_layer_outputs(cfg, _batch(7))
    assert len(outputs) >= n_layers > 10
    want = torch.bfloat16 if policy == "bfloat16_full" else torch.float32
    assert {y.dtype for y in outputs} == {want}
    rounded = [torch.equal(y, y.to(torch.bfloat16).to(y.dtype)) for y in outputs]
    assert all(rounded) if policy in BF16 else not any(rounded)


# --- remat -----------------------------------------------------------------------

@pytest.mark.parametrize("family", ["cnn-mvae", "cnn-vae-augment"])
def test_remat_recomputes_and_keeps_the_result(family, monkeypatch):
    """With the same weights and generator seed, ``remat`` on and off give
    the same loss and gradients (bit-identical on the CPU) and leave the
    generator in the same state, with dropout, reparameterisation noise and
    (cnn-vae) augmentation drawing from it. With remat the loss forward runs
    twice: once, then again in the backward."""
    if family == "cnn-mvae":
        kw = dict(model_name="cnn-mvae", input_type="visuotactile", use_pose=True)
    else:
        kw = dict(model_name="cnn-vae", input_type="visual", augment=True)
    runs = {}
    for remat in (False, True):
        cfg = ProblemConfig(problem_type="seq_modeling", latent_size=LATENT, batchsize=B,
                            remat=remat, **kw)
        model = setup_model(cfg.model_name, cross_modal=cfg.cross_modal, device="cpu",
                            latent_size=LATENT, seed=3,
                            **({"use_pose": True} if cfg.is_mvae else {}))
        optimizer = make_optimizer(cfg, model.parameters())
        state = create_train_state(model, optimizer)
        encoder = model.visual_encoder if cfg.is_mvae else model.encoder
        calls = []
        real = encoder.forward
        monkeypatch.setattr(encoder, "forward", lambda *a, **k: (calls.append(1), real(*a, **k))[1])
        monkeypatch.setattr(optimizer, "step", lambda: None)   # keep the gradients
        gen = torch.Generator().manual_seed(7)
        _, m = make_train_step(cfg, device="cpu")(state, _batch(6), gen, 0.5)
        runs[remat] = (float(m["loss"]), {n: p.grad.clone() for n, p in model.named_parameters()},
                       gen.get_state(), len(calls))
    (loss0, g0, s0, n0), (loss1, g1, s1, n1) = runs[False], runs[True]
    assert (n0, n1) == (1, 2)
    assert loss0 == loss1
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], rtol=1e-6, atol=0, msg=name)
    assert torch.equal(s0, s1)
