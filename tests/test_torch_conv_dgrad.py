"""The float32 convolutions' data gradient (``ops.kernels.conv_dgrad_f32``),
its custom operator ``mmdyn::conv_dgrad`` and the layers that call it
(``models.layers._ConvF32``: a convolution's input gradient, a transposed
convolution's forward), on the CPU.

The plain version spells out the CUDA kernel's GEMM; here it is held to
torch's ``conv2d_input`` / ``conv_transpose2d`` in float64 at every geometry
of the cnn models, and the operator's fake, autograd and export to what the
layers and the serving artifact need.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mmdyn_tpu_torch.models import layers, setup_model
from mmdyn_tpu_torch.models.vae import Decoder
from mmdyn_tpu_torch.ops import kernels
from mmdyn_tpu_torch.problems import ProblemConfig
from mmdyn_tpu_torch.serve import InferenceSession, export_session, load_exported
from tests.test_torch_conv_wgrad import HALLUCINATE, TRUNK, _step
from tests.torch_threads import one_torch_thread  # noqa: F401

# (transposed, (C_in, C_out, stride, padding, input side), batch): the cnn
# models' eight layers (TRUNK, HALLUCINATE) at batch 2; a ragged batch,
# batch 1 and odd sides; the two geometries the models do not use
CASES = ([(False, g[:2] + g[3:], 2) for g in TRUNK]
         + [(True, g[:2] + g[3:], 2) for g in HALLUCINATE]
         + [(True, (32, 3, 2, 1, 7), 3), (False, (3, 8, 2, 1, 9), 1),
            (True, (16, 8, 1, 0, 5), 1), (False, (8, 16, 1, 1, 6), 5),
            (True, (8, 4, 2, 0, 4), 2), (False, (4, 8, 2, 0, 11), 3)])
IDS = [f"{'deconv' if t else 'conv'}{g}-b{b}" for t, g, b in CASES]
DECONV = HALLUCINATE[1][:2] + HALLUCINATE[1][3:]     # deconv(128, 64, 4, 2, 1)


def _data(shape, seed, dtype=torch.float64):
    return torch.tensor(np.random.default_rng(seed).normal(size=shape), dtype=dtype)


def _case(transposed, geometry, batch, dtype=torch.float64):
    """(dy, weight, input size, want): the data-gradient call of the case and
    torch's answer. A transposed convolution's input is dy, its output dX."""
    c_in, c_out, s, p, side = geometry
    if transposed:
        dy, w = _data((batch, c_in, side, side), 1, dtype), _data((c_in, c_out, 4, 4), 2, dtype)
        want = F.conv_transpose2d(dy, w, None, s, p)
        return dy, w, want.shape[2:], want
    x_shape = (batch, c_in, side, side)
    w = _data((c_out, c_in, 4, 4), 2, dtype)
    out = (side + 2 * p - 4) // s + 1
    dy = _data((batch, c_out, out, out), 1, dtype)
    return dy, w, x_shape[2:], torch.nn.grad.conv2d_input(x_shape, w, dy, s, p)


@pytest.mark.parametrize("transposed, geometry, batch", CASES, ids=IDS)
def test_plain_matches_torch(transposed, geometry, batch):
    """In float64, the plain version, alone and through the wrapper's CPU
    dispatch, equals torch's data gradient / transposed convolution to
    rounding."""
    dy, w, size, want = _case(transposed, geometry, batch)
    s, p = geometry[2:4]
    got = kernels.conv_dgrad_plain(dy, w, size, s, p)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    assert torch.equal(kernels.conv_dgrad_f32(dy, w, size, s, p), got)


@pytest.mark.parametrize("kw, match", [
    (dict(weight=torch.zeros(8, 4, 3, 3)), "4 x 4 kernel"),
    (dict(weight=torch.zeros(8, 4, 4, 2)), "same on both axes"),
    (dict(stride=3), "stride 1 or 2"),
    (dict(padding=2), "padding 0 or 1"),
    (dict(dilation=2), "dilation 1"),
    (dict(groups=2), "groups 1"),
    (dict(dy=torch.zeros(2, 5, 4, 4)), "weight"),
    (dict(input_size=(10, 10)), "spatial"),
    (dict(input_size=(8, 8, 8)), "input_size"),
], ids=["k3", "k4x2", "stride3", "padding2", "dilation2", "groups2", "channels",
        "size", "rank"])
def test_geometry_outside_the_kernel_raises(kw, match):
    args = dict(dy=torch.zeros(2, 8, 4, 4), weight=torch.zeros(8, 4, 4, 4), input_size=(8, 8),
                stride=2, padding=1, dilation=1, groups=1) | kw
    with pytest.raises(ValueError, match=match):
        kernels.conv_dgrad_f32(**args)


def test_cpu_takes_the_plain_version(monkeypatch):
    """A CPU tensor takes the plain version and launches nothing."""
    calls = []
    real = kernels.conv_dgrad_plain
    monkeypatch.setattr(kernels, "conv_dgrad_plain", lambda *a: calls.append(a[3:]) or real(*a))
    monkeypatch.setattr(kernels.conv_dgrad_f32, "launches", 0)
    dy, w, size, _ = _case(True, DECONV, 2, torch.float32)
    kernels.conv_dgrad_f32(dy, w, size, 2, 1)
    assert calls == [(2, 1)] and kernels.conv_dgrad_f32.launches == 0


def test_a_card_call_without_a_card_raises(monkeypatch):
    """A call the dispatch sends to the kernel raises where the kernel cannot
    be built (here: no nvcc), rather than falling back to the plain
    version."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    plain = []
    monkeypatch.setattr(kernels, "conv_dgrad_plain", lambda *a: plain.append(a))
    monkeypatch.setattr(kernels, "_on_cpu", lambda t: False)
    monkeypatch.setattr(kernels.build, "_nvcc", no_nvcc)
    monkeypatch.setattr(kernels.build, "_lib_path", lambda name: kernels.build.BUILD_DIR / "none")
    dy, w, size, _ = _case(True, DECONV, 2, torch.float32)
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.conv_dgrad_f32(dy, w, size, 2, 1)
    assert plain == []


def test_cuda_wrapper_rejects_bad_input():
    """The kernel wrapper's checks run before any build or launch."""
    dy, w = torch.zeros((2, 8, 4, 4)), torch.zeros((8, 4, 4, 4))
    with pytest.raises(ValueError, match="float32 expected"):
        kernels._conv_dgrad_cuda(dy.double(), w, (8, 8), 2, 1)
    with pytest.raises(ValueError, match="contiguous"):
        kernels._conv_dgrad_cuda(dy.transpose(2, 3), w, (8, 8), 2, 1)


@pytest.mark.parametrize("transposed, geometry", [
    (False, (3, 2, 2, 1, 4)), (False, (2, 3, 1, 0, 5)), (False, (2, 3, 1, 1, 4)),
    (True, (3, 2, 1, 0, 2)), (True, (3, 2, 2, 1, 3)), (True, (2, 3, 2, 0, 2))],
    ids=["conv-s2p1", "conv-s1p0", "conv-s1p1", "deconv-s1p0", "deconv-s2p1", "deconv-s2p0"])
@pytest.mark.parametrize("bias", [False, True])
def test_layer_gradcheck(transposed, geometry, bias):
    """``_ConvF32`` (the plain versions of both kernels on the CPU) against
    finite differences in float64, in the input, the weight and the bias."""
    c_in, c_out, s, p, side = geometry
    cls = layers.ConvTranspose2d if transposed else layers.Conv2d
    layer = cls(c_in, c_out, 4, s, p, bias=bias).double()
    x = _data((1, c_in, side, side), 3).requires_grad_(True)
    params = (layer.weight,) + ((layer.bias,) if bias else ())

    def f(x, *ps):
        return layers._ConvF32.apply(x, ps[0], ps[1] if bias else None, transposed,
                                     layer.stride, layer.padding, layer.output_padding,
                                     layer.dilation, layer.groups)

    assert torch.autograd.gradcheck(f, (x,) + params)


@pytest.mark.parametrize("geometry", [(3, 2, 2, 1, 4), (2, 3, 1, 0, 5)], ids=["s2", "s1"])
def test_operator_checks(geometry):
    """``torch.library.opcheck``: the fake's shapes, the autograd
    registration and the schema against the real operator, and its gradients
    to dy and the weight against finite differences in float64."""
    c_in, c_out, s, p, side = geometry
    w = _data((c_out, c_in, 4, 4), 2)
    out = (side + 2 * p - 4) // s + 1
    dy = _data((1, c_out, out, out), 1)
    torch.library.opcheck(kernels._conv_dgrad_op, (dy, w, [side, side], s, p))
    dy.requires_grad_(True)
    w.requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda a, b: kernels.conv_dgrad_f32(a, b, (side, side), s, p), (dy, w))


def test_fake_shapes():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        dy, w = torch.empty((3, 64, 8, 8)), torch.empty((64, 32, 4, 4))
        got = kernels.conv_dgrad_f32(dy, w, (16, 16), 2, 1)
        assert got.shape == (3, 32, 16, 16) and got.dtype == torch.float32


@pytest.mark.parametrize("policy, calls", [("float32", 14), ("bfloat16", 0),
                                           ("bfloat16_full", 0)])
def test_dyn_step_calls(monkeypatch, policy, calls):
    """A float32 dyn step: 6 encoder data gradients (layers 2-4 of two
    encoders; the first layer's input is data) and 8 decoder forwards (4
    layers of two decoders, their subsets in one call); the bf16 policies'
    convolutions never reach it."""
    seen = []
    real = kernels.conv_dgrad_plain
    monkeypatch.setattr(kernels, "conv_dgrad_plain",
                        lambda *a: seen.append(tuple(a[0].shape[1:])) or real(*a))
    _step(policy)
    assert len(seen) == calls
    if calls:   # the decoders' forwards come first, in the loss; then the backward
        assert seen[:4] == [(256, 5, 5), (128, 8, 8), (64, 16, 16), (32, 32, 32)]
        assert sorted(set(seen[8:])) == [(64, 16, 16), (128, 8, 8), (256, 5, 5)]


def test_export_records_the_operator(tmp_path):
    """``torch.export`` of a decoder and of a cnn-mvae serving session records
    each transposed convolution as one ``mmdyn.conv_dgrad`` call, no
    ``conv_transpose2d``; the exported decoder and the loaded artifact
    compute what the eager decoder and ``predict`` do, bit for bit."""
    torch.manual_seed(0)
    dec = Decoder(8)
    z = torch.randn(4, 8)
    with torch.no_grad():
        exported = torch.export.export(dec, (z,))
        targets = [str(n.target) for n in exported.graph.nodes if n.op == "call_function"]
        assert targets.count("mmdyn.conv_dgrad.default") == 4
        assert not any("conv_transpose" in t for t in targets)
        assert torch.equal(exported.module()(z), dec(z))

    cfg = ProblemConfig(problem_type="seq_modeling", model_name="cnn-mvae",
                        input_type="visuotactile", use_pose=True, latent_size=8, batchsize=2)
    model = setup_model("cnn-mvae", cross_modal=True, device="cpu", latent_size=8,
                        use_pose=True)
    session = InferenceSession(cfg, model.state_dict(), device="cpu")
    manifest = export_session(session, tmp_path / "art", batch_size=2,
                              modalities=("visual", "tactile"))
    program = torch.export.load(tmp_path / "art" / "predict.pt2")
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("mmdyn.conv_dgrad.default") == 8
    assert not any("conv_transpose" in t for t in targets)
    rng = np.random.default_rng(4)
    x = {m: rng.uniform(size=(2, 64, 64, 3)).astype(np.float32) for m in ("visual", "tactile")}
    got, want = load_exported(tmp_path / "art")(**x), session.predict(**x)
    for k in manifest["outputs"]:
        assert torch.equal(got[k], want[k]), k
