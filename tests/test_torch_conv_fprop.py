"""The float32 convolutions' forward (``ops.kernels.conv_fprop_f32``), its
custom operator ``mmdyn::conv_fprop`` and the layers that call it
(``models.layers._ConvF32``: a convolution's forward, a transposed
convolution's data gradient), on the CPU.

The plain version is torch's convolution (the kernel's sum, three TF32
products a term, has no counterpart in plain operations); here it is held to
autograd's data gradient of ``conv_transpose2d`` in float64, and with the
wrapper to the JAX package's ``Conv2d`` / ``ConvTranspose2d`` in float32, at
every geometry of the cnn models; and the operator's fake, autograd and
export to what the layers and the serving artifact need.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mmdyn_tpu.models import layers as jax_layers
from mmdyn_tpu_torch.models import layers, setup_model
from mmdyn_tpu_torch.models.vae import conv_trunk
from mmdyn_tpu_torch.ops import kernels
from mmdyn_tpu_torch.problems import ProblemConfig
from mmdyn_tpu_torch.serve import InferenceSession, export_session, load_exported
from tests.test_torch_conv_wgrad import HALLUCINATE, TRUNK, _step
from tests.torch_threads import one_torch_thread  # noqa: F401

# (transposed, (C_in, C_out, stride, padding, input side), batch): the cnn
# models' eight layers (TRUNK, HALLUCINATE) at batch 2; a ragged batch,
# batch 1, odd sides and odd channel counts; the two geometries the models do
# not use. A transposed layer's call is its data gradient: x is its output
# gradient, the weight (C_in, C_out, 4, 4) read as a convolution's.
CASES = ([(False, g[:2] + g[3:], 2) for g in TRUNK]
         + [(True, g[:2] + g[3:], 2) for g in HALLUCINATE]
         + [(False, (3, 5, 2, 1, 9), 3), (True, (5, 3, 2, 1, 7), 1),
            (False, (7, 9, 1, 0, 6), 1), (True, (9, 7, 1, 0, 3), 5),
            (False, (4, 8, 1, 1, 5), 2), (True, (8, 4, 2, 0, 4), 3)])
IDS = [f"{'deconv' if t else 'conv'}{g}-b{b}" for t, g, b in CASES]
CONV = TRUNK[1][:2] + TRUNK[1][3:]                   # conv(32, 64, 4, 2, 1)


def _data(shape, seed, dtype=torch.float64):
    return torch.tensor(np.random.default_rng(seed).normal(size=shape), dtype=dtype)


def _case(transposed, geometry, batch, dtype=torch.float64):
    """(x, weight, want) of the case's call: a convolution's input and its
    forward by torch, or a transposed convolution's output gradient and its
    data gradient by torch's autograd."""
    c_in, c_out, s, p, side = geometry
    if not transposed:
        x, w = _data((batch, c_in, side, side), 1, dtype), _data((c_out, c_in, 4, 4), 2, dtype)
        return x, w, F.conv2d(x, w, None, s, p)
    w = _data((c_in, c_out, 4, 4), 2, dtype)
    inp = _data((batch, c_in, side, side), 3, dtype).requires_grad_(True)
    y = F.conv_transpose2d(inp, w, None, s, p)
    g = _data(y.shape, 1, dtype)
    y.backward(g)
    return g, w, inp.grad


@pytest.mark.parametrize("transposed, geometry, batch", CASES, ids=IDS)
def test_plain_matches_torch(transposed, geometry, batch):
    """In float64, the plain version, alone and through the wrapper's CPU
    dispatch, equals torch's convolution / transposed convolution's data
    gradient to rounding."""
    x, w, want = _case(transposed, geometry, batch)
    s, p = geometry[2:4]
    got = kernels.conv_fprop_plain(x, w, s, p)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    assert torch.equal(kernels.conv_fprop_f32(x, w, s, p), got)


def _jax_call(transposed, geometry, x, w):
    """The JAX package's answer for the case in float32: its ``Conv2d``
    forward, or the data gradient (``jax.vjp``) of its ``ConvTranspose2d``,
    with torch's weight carried by ``utils/weights.py``'s rules."""
    c_in, c_out, s, p, side = geometry
    nhwc = jnp.asarray(x.permute(0, 2, 3, 1).numpy())
    if not transposed:
        module = jax_layers.Conv2d(c_out, 4, s, p, use_bias=False)
        hwio = w.numpy().transpose(2, 3, 1, 0)
        y = module.apply({"params": {"kernel": jnp.asarray(hwio)}}, nhwc)
    else:
        module = jax_layers.ConvTranspose2d(c_out, 4, s, p, use_bias=False)
        flax = np.ascontiguousarray(w.numpy().transpose(2, 3, 0, 1)[::-1, ::-1])
        params = {"params": {"kernel": jnp.asarray(flax)}}
        inp = jnp.zeros((x.shape[0], side, side, c_in), jnp.float32)
        _, vjp = jax.vjp(lambda a: module.apply(params, a), inp)
        (y,) = vjp(nhwc)
    return torch.from_numpy(np.array(y)).permute(0, 3, 1, 2)


@pytest.mark.parametrize("transposed, geometry, batch", CASES[:8], ids=IDS[:8])
def test_plain_matches_jax(transposed, geometry, batch):
    """In float32, the wrapper's CPU answer against the JAX package's at the
    models' eight layers: float32 sums of up to 2,048 products in another
    order, within 1e-5 of the largest element."""
    x, w, _ = _case(transposed, geometry, batch, torch.float32)
    x, w = x.detach(), w.detach()
    s, p = geometry[2:4]
    got = kernels.conv_fprop_f32(x, w, s, p)
    want = _jax_call(transposed, geometry, x, w)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("kw, match", [
    (dict(weight=torch.zeros(8, 4, 3, 3)), "4 x 4 kernel"),
    (dict(weight=torch.zeros(8, 4, 4, 2)), "same on both axes"),
    (dict(stride=3), "stride 1 or 2"),
    (dict(padding=2), "padding 0 or 1"),
    (dict(dilation=2), "dilation 1"),
    (dict(groups=2), "groups 1"),
    (dict(x=torch.zeros(2, 5, 8, 8)), "weight"),
    (dict(x=torch.zeros(2, 4, 8)), "weight"),
    (dict(x=torch.zeros(2, 4, 2, 2), padding=0), "smaller than the kernel"),
], ids=["k3", "k4x2", "stride3", "padding2", "dilation2", "groups2", "channels", "rank",
        "small"])
def test_geometry_outside_the_kernel_raises(kw, match):
    args = dict(x=torch.zeros(2, 4, 8, 8), weight=torch.zeros(8, 4, 4, 4), stride=2,
                padding=1, dilation=1, groups=1) | kw
    with pytest.raises(ValueError, match=match):
        kernels.conv_fprop_f32(**args)


def test_cpu_takes_the_plain_version(monkeypatch):
    """A CPU tensor takes the plain version and launches nothing."""
    calls = []
    real = kernels.conv_fprop_plain
    monkeypatch.setattr(kernels, "conv_fprop_plain", lambda *a: calls.append(a[2:]) or real(*a))
    monkeypatch.setattr(kernels.conv_fprop_f32, "launches", 0)
    x, w, _ = _case(False, CONV, 2, torch.float32)
    kernels.conv_fprop_f32(x, w, 2, 1)
    assert calls == [(2, 1)] and kernels.conv_fprop_f32.launches == 0


def test_a_card_call_without_a_card_raises(monkeypatch):
    """A call the dispatch sends to the kernel raises, naming why the kernel
    cannot run (here: no nvcc to build it), rather than falling back to the
    plain version; a tensor on a device with no kernel names that device."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    plain = []
    real_on_cpu = kernels._on_cpu
    monkeypatch.setattr(kernels, "conv_fprop_plain", lambda *a: plain.append(a))
    monkeypatch.setattr(kernels, "_on_cpu", lambda t: False)
    monkeypatch.setattr(kernels.build, "_nvcc", no_nvcc)
    monkeypatch.setattr(kernels.build, "_lib_path", lambda name: kernels.build.BUILD_DIR / "none")
    x, w, _ = _case(False, CONV, 2, torch.float32)
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.conv_fprop_f32(x, w, 2, 1)
    assert plain == []
    with pytest.raises(ValueError, match="no kernel for device meta"):
        real_on_cpu(torch.empty(1, device="meta"))


def test_cuda_wrapper_rejects_bad_input():
    """The kernel wrapper's checks run before any build or launch."""
    x, w = torch.zeros((2, 4, 8, 8)), torch.zeros((8, 4, 4, 4))
    with pytest.raises(ValueError, match="float32 expected"):
        kernels._conv_fprop_cuda(x.double(), w, 2, 1)
    with pytest.raises(ValueError, match="contiguous"):
        kernels._conv_fprop_cuda(x.transpose(2, 3), w, 2, 1)
    with pytest.raises(ValueError, match="on meta"):
        kernels._conv_fprop_cuda(x, w.to("meta"), 2, 1)


@pytest.mark.parametrize("transposed, geometry", [
    (False, (3, 2, 2, 1, 4)), (False, (2, 3, 1, 0, 5)), (False, (2, 3, 1, 1, 4)),
    (True, (3, 2, 1, 0, 2)), (True, (3, 2, 2, 1, 3)), (True, (2, 3, 2, 0, 2))],
    ids=["conv-s2p1", "conv-s1p0", "conv-s1p1", "deconv-s1p0", "deconv-s2p1", "deconv-s2p0"])
@pytest.mark.parametrize("bias", [False, True])
def test_layer_gradcheck(transposed, geometry, bias):
    """The port's ``Conv2d`` / ``ConvTranspose2d`` modules (``_ConvF32``, the
    plain versions of the three kernels on the CPU) against finite
    differences in float64, in the input, the weight and the bias."""
    c_in, c_out, s, p, side = geometry
    cls = layers.ConvTranspose2d if transposed else layers.Conv2d
    layer = cls(c_in, c_out, 4, s, p, bias=bias).double()
    x = _data((1, c_in, side, side), 3).requires_grad_(True)
    names = ("weight", "bias") if bias else ("weight",)
    params = tuple(getattr(layer, n).detach().clone().requires_grad_(True) for n in names)

    def f(x, *ps):
        return torch.func.functional_call(layer, dict(zip(names, ps)), (x,))

    assert torch.autograd.gradcheck(f, (x,) + params)


@pytest.mark.parametrize("geometry", [(3, 2, 2, 1, 4), (2, 3, 1, 0, 5)], ids=["s2", "s1"])
def test_operator_checks(geometry):
    """``torch.library.opcheck``: the fake's shapes, the autograd
    registration and the schema against the real operator, and its gradients
    to x and the weight against finite differences in float64."""
    c_in, c_out, s, p, side = geometry
    x, w = _data((2, c_in, side, side), 1), _data((c_out, c_in, 4, 4), 2)
    torch.library.opcheck(kernels._conv_fprop_op, (x, w, s, p))
    x.requires_grad_(True)
    w.requires_grad_(True)
    assert torch.autograd.gradcheck(lambda a, b: kernels.conv_fprop_f32(a, b, s, p), (x, w))


def test_fake_shapes():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        x, w = torch.empty((3, 128, 8, 8)), torch.empty((256, 128, 4, 4))
        got = kernels.conv_fprop_f32(x, w, 1, 0)
        assert got.shape == (3, 256, 5, 5) and got.dtype == torch.float32


@pytest.mark.parametrize("policy, calls", [("float32", 16), ("bfloat16", 0),
                                           ("bfloat16_full", 0)])
def test_dyn_step_calls(monkeypatch, policy, calls):
    """A float32 dyn step: the 8 forwards of two encoders' four convolutions,
    then in the backward the 8 data gradients of two decoders' four
    transposed convolutions (their subsets in one call); the bf16 policies'
    convolutions never reach it."""
    seen = []
    real = kernels.conv_fprop_plain
    monkeypatch.setattr(kernels, "conv_fprop_plain",
                        lambda *a: seen.append(tuple(a[0].shape[1:])) or real(*a))
    _step(policy)
    assert len(seen) == calls
    if calls:
        trunk = [(3, 64, 64), (32, 32, 32), (64, 16, 16), (128, 8, 8)]
        assert seen[:8] == trunk * 2
        assert sorted(set(seen[8:])) == [(3, 64, 64), (32, 32, 32), (64, 16, 16),
                                         (128, 8, 8)]


def test_export_records_the_operator(tmp_path):
    """``torch.export`` of an encoder trunk and of a cnn-mvae serving session
    records each convolution as one ``mmdyn.conv_fprop`` call, no
    ``aten.convolution``; the exported trunk and the loaded artifact compute
    what the eager trunk and ``predict`` do, bit for bit."""
    torch.manual_seed(0)
    trunk = conv_trunk()
    x = torch.randn(2, 3, 64, 64)
    with torch.no_grad():
        exported = torch.export.export(trunk, (x,))
        targets = [str(n.target) for n in exported.graph.nodes if n.op == "call_function"]
        assert targets.count("mmdyn.conv_fprop.default") == 4
        assert not any("convolution" in t or "conv2d" in t for t in targets)
        assert torch.equal(exported.module()(x), trunk(x))

    cfg = ProblemConfig(problem_type="seq_modeling", model_name="cnn-mvae",
                        input_type="visuotactile", use_pose=True, latent_size=8, batchsize=2)
    model = setup_model("cnn-mvae", cross_modal=True, device="cpu", latent_size=8,
                        use_pose=True)
    session = InferenceSession(cfg, model.state_dict(), device="cpu")
    manifest = export_session(session, tmp_path / "art", batch_size=2,
                              modalities=("visual", "tactile"))
    program = torch.export.load(tmp_path / "art" / "predict.pt2")
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("mmdyn.conv_fprop.default") == 8
    assert not any("convolution" in t or "conv2d" in t for t in targets)
    rng = np.random.default_rng(4)
    x = {m: rng.uniform(size=(2, 64, 64, 3)).astype(np.float32) for m in ("visual", "tactile")}
    got, want = load_exported(tmp_path / "art")(**x), session.predict(**x)
    for k in manifest["outputs"]:
        assert torch.equal(got[k], want[k]), k
