"""``ops.kernels.fused_bn_swish`` (the plain version, which the CPU runs),
the lone swishes' ``F.silu`` and the cnn trunks' routing through them
(``models/layers.py::run_sequential``).

The plain forward is the composite's own operations (``var_mean``, then
``train_batch_norm``'s arithmetic, then ``swish``); the backward is the JAX
package's closed form (``_train_bn_manual``) with swish's derivative folded
in. Both are held against autograd of the composite (float64 and float32)
and against the JAX package's ``_train_bn_manual`` + ``swish``, per group
(float32: the JAX BatchNorm casts its statistics and its backward to float32
whatever the input), at the encoders' and the decoders' channel and spatial
shapes at small batches.

Tolerances (max |got - want| / max |want|):
* float64: 1e-10. The forms agree algebraically; what is left is float64
  rounding of sums over at most 8,192 elements.
* float32: 5e-6 for y; 5e-5 for dx, dweight and dbias. The closed form and
  autograd's chain (and the JAX package's E[x^2] - mean^2 variance) round
  differently, and dx subtracts M * ct, sum(ct) and x_hat * sum(ct * x_hat),
  sums of up to 8,192 float32 terms each.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from mmdyn_tpu.models.layers import _train_bn_manual
from mmdyn_tpu.models.layers import swish as jax_swish

from mmdyn_tpu_torch.models import Regressor, setup_model
from mmdyn_tpu_torch.models import layers
from mmdyn_tpu_torch.models.vae import Decoder, Encoder
from mmdyn_tpu_torch.ops import kernels
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = {torch.float64: (1e-10, 1e-10), torch.float32: (5e-6, 5e-5)}   # (y, gradients)
EPS = 1e-5

# (rows, C, H, W), groups: the encoders' (4 rows) and the decoders' (4
# subsets of 2 rows) BatchNorm + swish shapes
BN_CASES = [((4, 64, 16, 16), 1), ((4, 128, 8, 8), 1), ((4, 256, 5, 5), 1),
            ((8, 128, 8, 8), 4), ((8, 64, 16, 16), 4), ((8, 32, 32, 32), 4)]
# the encoders' first conv, FC, and the decoders' upsample
SWISH_SHAPES = [(4, 32, 32, 32), (4, 512), (8, 6400)]


def gap(a, b):
    a, b = (torch.as_tensor(np.array(t, dtype=np.float64)) for t in (a, b))
    return float((a - b).abs().max() / b.abs().max())


def bn_case(shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g, dtype=dtype)
    w = 1.0 + 0.2 * torch.randn(shape[1], generator=g, dtype=dtype)
    b = 0.2 * torch.randn(shape[1], generator=g, dtype=dtype)
    gy = torch.randn(shape, generator=g, dtype=dtype)
    return x, w, b, gy


def composite(x, w, b, groups):
    """Today's composite, differentiated op by op: in float32 the model's
    own ``train_batch_norm`` then ``swish``; in float64 the same operations
    with float64 statistics (``train_batch_norm`` takes float32 ones)."""
    if x.dtype == torch.float32:
        return layers.swish(layers.train_batch_norm(x, w, b, groups))
    c = x.shape[1]
    xg = x.reshape(groups, x.shape[0] // groups, c, -1)
    var, mean = torch.var_mean(xg, dim=(1, 3), correction=0, keepdim=True)
    u = (xg - mean) * (torch.rsqrt(var + EPS) * w.reshape(1, 1, c, 1)) + b.reshape(1, 1, c, 1)
    return layers.swish(u).reshape(x.shape)


@jax.jit
def _jax_bn_swish_vjp(x, w, b, gy):
    y, vjp = jax.vjp(lambda *a: jax_swish(_train_bn_manual(*a, EPS)), x, w, b)
    return (y,) + vjp(gy)


def jax_bn_swish(x, w, b, gy, groups):
    """y, dx, dweight, dbias of the JAX package's ``_train_bn_manual`` +
    ``swish``, one group at a time in NHWC, the groups' parameter gradients
    summed."""
    ys, dxs, dw, db = [], [], 0.0, 0.0
    nhwc = lambda a: jnp.asarray(np.moveaxis(a, 1, -1))  # noqa: E731
    for xg, gg in zip(np.split(x.numpy(), groups), np.split(gy.numpy(), groups)):
        y, dxg, dwg, dbg = _jax_bn_swish_vjp(nhwc(xg), jnp.asarray(w.numpy()),
                                             jnp.asarray(b.numpy()), nhwc(gg))
        ys.append(np.moveaxis(np.asarray(y), -1, 1))
        dxs.append(np.moveaxis(np.asarray(dxg), -1, 1))
        dw, db = dw + np.asarray(dwg), db + np.asarray(dbg)
    return np.concatenate(ys), np.concatenate(dxs), dw, db


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("shape,groups", BN_CASES, ids=[f"{s}-g{g}" for s, g in BN_CASES])
def test_bn_swish_plain_against_composite_and_jax(shape, groups, dtype):
    x, w, b, gy = bn_case(shape, dtype, seed=sum(shape) + groups)
    tol_y, tol_g = TOL[dtype]
    got = [x.clone().requires_grad_(), w.clone().requires_grad_(), b.clone().requires_grad_()]
    y = kernels.fused_bn_swish(*got, groups)
    grads = torch.autograd.grad(y, got, gy)
    ref = [t.clone().requires_grad_() for t in (x, w, b)]
    y_ref = composite(*ref, groups)
    for a, want, tol in zip((y,) + grads, (y_ref,) + torch.autograd.grad(y_ref, ref, gy),
                            (tol_y,) + (tol_g,) * 3):
        assert gap(a.detach(), want.detach()) <= tol
    if dtype == torch.float64:
        return
    for a, ref_j, tol in zip((y,) + grads, jax_bn_swish(x, w, b, gy, groups),
                             (tol_y,) + (tol_g,) * 3):
        assert gap(a.detach(), ref_j) <= tol
    # the forward is the composite's operations: the same bits
    assert torch.equal(y, y_ref)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("shape", SWISH_SHAPES, ids=str)
def test_swish_plain_against_composite_and_jax(shape, dtype):
    """A lone swish runs as ``F.silu``: within rounding of the composite
    ``x * sigmoid(x)`` and of the JAX package's ``swish``, forward and
    backward."""
    g = torch.Generator().manual_seed(len(shape))
    x = 4.0 * torch.randn(shape, generator=g, dtype=dtype)
    gy = torch.randn(shape, generator=g, dtype=dtype)
    tol_y, tol_g = TOL[dtype]
    xk, xr = x.clone().requires_grad_(), x.clone().requires_grad_()
    y, y_ref = F.silu(xk), layers.swish(xr)
    assert gap(y.detach(), y_ref.detach()) <= tol_y
    (dx,), (dx_ref,) = torch.autograd.grad(y, xk, gy), torch.autograd.grad(y_ref, xr, gy)
    assert gap(dx, dx_ref) <= tol_g
    with jax.enable_x64(dtype == torch.float64):
        yj, vjp = jax.vjp(jax_swish, jnp.asarray(x.numpy()))
        (dxj,) = vjp(jnp.asarray(gy.numpy()))
    assert gap(y.detach(), yj) <= tol_y
    assert gap(dx, dxj) <= tol_g


def test_bn_swish_stats_and_checks():
    """The plain version's (G, C) statistics are ``var_mean``'s, biased, and
    its inv their rsqrt; the wrapper refuses a batch that does not split
    into the groups and mismatched parameters."""
    x, w, b, _ = bn_case((8, 3, 4, 4), torch.float32, seed=3)
    y, mean, var, inv = kernels.bn_swish_plain(x, w, b, 4)
    v, m = torch.var_mean(x.reshape(4, 2, 3, -1), dim=(1, 3), correction=0)
    assert torch.equal(mean, m) and torch.equal(var, v) and y.shape == x.shape
    assert torch.equal(inv, torch.rsqrt(v + EPS))
    with pytest.raises(ValueError, match="does not split"):
        kernels._bn_swish_shape(x, w, b, 3)
    with pytest.raises(ValueError, match="weight and bias"):
        kernels._bn_swish_shape(x, w[:2], b, 1)


def spies(monkeypatch):
    """Count the ``fused_bn_swish`` calls the models make (the name
    ``layers`` imported) and their ``F.silu`` calls."""
    calls = {"bn_swish": 0, "swish": 0}

    def counted(name, fn):
        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call

    monkeypatch.setattr(layers, "fused_bn_swish", counted("bn_swish", kernels.fused_bn_swish))
    class Functional:           # ``torch.nn.functional`` as ``layers`` sees it
        silu = staticmethod(counted("swish", F.silu))

        def __getattr__(self, name):
            return getattr(F, name)

    monkeypatch.setattr(layers, "F", Functional())
    return calls


def unfused(mp):
    """Within ``mp`` every BatchNorm + swish pair runs as its two modules, as
    before the wrappers (the lone swishes stay ``F.silu``)."""
    mp.setattr(layers.TrainBatchNorm, "fusable", lambda self, x: False)


@pytest.mark.parametrize("family,sites", [("cnn-mvae", (12, 6)), ("cnn-vae", (6, 3)),
                                          ("regressor", (3, 2))])
def test_models_run_through_the_wrappers(monkeypatch, family, sites):
    """A float32 forward calls ``fused_bn_swish`` once per BatchNorm + swish
    and ``F.silu`` once per lone swish (the MVAE: two encoders of 3 + 2, two
    decoders of 3 + 1); its output equals, bit for bit, the forward with each
    pair run as its two modules (the plain forward is the composite's
    operations), and its gradients are within float32 tolerance of
    autograd's."""
    calls = spies(monkeypatch)
    kw = {"cnn-mvae": dict(latent_size=8, use_pose=True), "cnn-vae": dict(latent_size=8),
          "regressor": {}}[family]
    model = setup_model(family, cross_modal=family == "cnn-mvae", device="cpu",
                        dropout_rate=0.0, seed=0, **kw)
    rng = np.random.default_rng(0)
    img = lambda: torch.as_tensor(rng.uniform(size=(4, 64, 64, 3)), dtype=torch.float32)  # noqa: E731

    def run():
        torch.manual_seed(0)
        gen = torch.Generator().manual_seed(0)
        if family == "cnn-mvae":
            out = model([xv, xt], xp, generator=gen)
            loss = sum(o.double().square().sum() for o in out if o is not None)
        elif family == "cnn-vae":
            out = model(xv, generator=gen)
            loss = sum(o.double().square().sum() for o in out)
        else:
            out = (model(xv),)
            loss = out[0].double().square().sum()
        return out, torch.autograd.grad(loss, list(model.parameters()))

    xv, xt = img(), img()
    xp = torch.as_tensor(rng.normal(size=(4, 7)), dtype=torch.float32)
    out, grads = run()
    assert (calls["bn_swish"], calls["swish"]) == sites
    with pytest.MonkeyPatch.context() as mp:
        unfused(mp)
        want, want_grads = run()
    assert (calls["bn_swish"], calls["swish"]) == (sites[0], 2 * sites[1])
    for a, b in zip(out, want):
        if a is not None:
            assert torch.equal(a, b)
    for a, b in zip(grads, want_grads):
        assert gap(a, b) <= 1e-4


def _trunk_outputs(dtype_policy, bn_mode="batch"):
    torch.manual_seed(0)
    enc = Encoder(8, compute_dtype=dtype_policy, bn_mode=bn_mode, dropout_rate=0.0)
    dec = Decoder(8, compute_dtype=dtype_policy, bn_mode=bn_mode)
    for m in enc.modules():
        if isinstance(m, layers.TrainBatchNorm):
            m.mean.normal_()
            m.var.uniform_(0.5, 2.0)
    x = torch.rand(4, 64, 64, 3)
    z = torch.randn(2, 4, 8)
    return enc(x), dec(z)


@pytest.mark.parametrize("policy,bn_mode,sites", [
    ("bfloat16_full", "batch", (0, 0)), ("float32", "frozen", (0, 3)),
    ("bfloat16", "batch", (6, 3))])
def test_paths_kept_and_taken(monkeypatch, policy, bn_mode, sites):
    """``bfloat16_full`` (bf16 activations) keeps the modules' own calls and
    ``frozen`` its BatchNorm + swish pairs (its lone swishes take
    ``F.silu``), bit for bit what they computed before; ``bfloat16``
    (float32 activations) takes the wrappers. (BatchNorm + swish, swish)
    calls of an encoder and a decoder: ``sites``."""
    calls = spies(monkeypatch)
    got = _trunk_outputs(policy, bn_mode)
    assert (calls["bn_swish"], calls["swish"]) == sites
    with pytest.MonkeyPatch.context() as mp:
        unfused(mp)
        want = _trunk_outputs(policy, bn_mode)
    for a, b in zip(got, want):
        assert all(torch.equal(p, q) for p, q in zip(a, b))


def test_collect_records_var_mean_and_fuses(monkeypatch):
    """``collect`` takes the wrappers and still records the buffers from
    ``var_mean``, as before; its output equals the module-by-module one."""
    calls = spies(monkeypatch)
    torch.manual_seed(0)
    enc = Encoder(8, bn_mode="collect", dropout_rate=0.0)
    x = torch.rand(4, 64, 64, 3)
    got, stats = enc(x), layers.bn_stats(enc)
    assert (calls["bn_swish"], calls["swish"]) == (3, 2)
    with pytest.MonkeyPatch.context() as mp:
        unfused(mp)
        want = enc(x)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for name, v in layers.bn_stats(enc).items():
        assert torch.equal(stats[name]["mean"], v["mean"])
        assert torch.equal(stats[name]["var"], v["var"])


def test_export_traces_the_modules(monkeypatch, tmp_path):
    """``torch.export`` (the serving artifact) records each BatchNorm + swish
    pair as one call of the ``mmdyn::bn_swish`` custom operator, none of the
    composite's ``var_mean``; the exported program, and the one
    ``torch.export.save`` / ``load`` gives back, compute what the eager model
    does, bit for bit."""
    calls = spies(monkeypatch)
    torch.manual_seed(0)
    dec = Decoder(8)
    z = torch.randn(4, 8)
    with torch.no_grad():
        exported = torch.export.export(dec, (z,))
        assert calls == {"bn_swish": 3, "swish": 1}
        targets = [str(n.target) for n in exported.graph.nodes if n.op == "call_function"]
        assert targets.count("mmdyn.bn_swish.default") == 3
        assert not any("var_mean" in t for t in targets)
        want = dec(z)
        assert torch.equal(exported.module()(z), want)
        torch.export.save(exported, tmp_path / "dec.pt2")
        assert torch.equal(torch.export.load(tmp_path / "dec.pt2").module()(z), want)


def test_multi_rank_mesh_keeps_the_all_reduced_statistics(monkeypatch):
    """Inside a mesh of more than one rank the trunks keep the modules' own
    calls, whose statistics go through ``parallel.mesh.var_mean``; a
    one-rank group (``active_mesh`` None) takes the wrappers, within float32
    rounding of it (``F.silu`` rounds otherwise than ``x * sigmoid(x)``)."""
    calls = spies(monkeypatch)
    reduced = []

    def local_var_mean(x, dim, mesh, keepdim=True):
        reduced.append(dim)
        return torch.var_mean(x, dim=dim, correction=0, keepdim=keepdim)

    monkeypatch.setattr(layers, "active_mesh", lambda: object())
    monkeypatch.setattr(layers, "var_mean", local_var_mean)
    torch.manual_seed(0)
    dec = Decoder(8)
    z = torch.randn(2, 4, 8)
    got = dec(z)
    assert calls == {"bn_swish": 0, "swish": 0} and len(reduced) == 3
    monkeypatch.setattr(layers, "active_mesh", lambda: None)
    assert gap(dec(z).detach(), got.detach()) <= TOL[torch.float32][0]
    assert calls == {"bn_swish": 3, "swish": 1}


def test_state_dict_keys_unchanged():
    """The trunks' ``Sequential`` children and every ``state_dict`` key stay
    as the reference names them (``utils/weights.py``, checkpoints)."""
    enc, dec, reg = Encoder(8), Decoder(8), Regressor()
    trunk = ["conv_net.0.weight", "conv_net.2.weight", "conv_net.3.weight", "conv_net.3.bias",
             "conv_net.5.weight", "conv_net.6.weight", "conv_net.6.bias", "conv_net.8.weight",
             "conv_net.9.weight", "conv_net.9.bias", "fc_net.0.weight", "fc_net.0.bias"]
    assert list(enc.state_dict()) == trunk + ["linear_means.weight", "linear_means.bias",
                                              "linear_log_var.weight", "linear_log_var.bias"]
    assert list(reg.state_dict()) == trunk + [f"out_net.{i}.{p}" for i in (0, 2, 4)
                                              for p in ("weight", "bias")]
    assert list(dec.state_dict()) == [
        "upsample.0.weight", "upsample.0.bias", "hallucinate.0.weight", "hallucinate.1.weight",
        "hallucinate.1.bias", "hallucinate.3.weight", "hallucinate.4.weight",
        "hallucinate.4.bias", "hallucinate.6.weight", "hallucinate.7.weight",
        "hallucinate.7.bias", "hallucinate.9.weight"]
