"""The float32 convolutions' weight gradient (``ops.kernels.conv_wgrad_f32``)
and the layers that call it (``models.layers._ConvF32``), on the CPU.

The plain version spells out the CUDA kernel's implicit GEMM; here it is held
to torch's autograd of ``nn.Conv2d`` / ``nn.ConvTranspose2d`` at every
geometry of the cnn models, and the layers' other outputs to torch's: bit for
bit where they are torch's calls (``conv_fprop_f32``'s plain version is
torch's convolution, ``tests/test_torch_conv_fprop.py``), to float32
rounding where they are ``conv_dgrad_f32``'s (``tests/test_torch_conv_dgrad.py``).
"""

import numpy as np
import pytest
import torch
import torch.nn as nn

from mmdyn_tpu_torch.models import layers, setup_model
from mmdyn_tpu_torch.models.vae import Decoder, conv_trunk
from mmdyn_tpu_torch.ops import kernels
from mmdyn_tpu_torch.problems import ProblemConfig, make_optimizer
from mmdyn_tpu_torch.train import create_train_state, make_train_step
from tests.torch_threads import one_torch_thread  # noqa: F401

# (C_in, C_out, kernel, stride, padding, input side) of every layer of
# conv_trunk (the encoders and the regressor) and Decoder.hallucinate
TRUNK = [(3, 32, 4, 2, 1, 64), (32, 64, 4, 2, 1, 32), (64, 128, 4, 2, 1, 16),
         (128, 256, 4, 1, 0, 8)]
HALLUCINATE = [(256, 128, 4, 1, 0, 5), (128, 64, 4, 2, 1, 8), (64, 32, 4, 2, 1, 16),
               (32, 3, 4, 2, 1, 32)]
CASES = [(False, g) for g in TRUNK] + [(True, g) for g in HALLUCINATE]
IDS = [f"{'deconv' if t else 'conv'}{g[:5]}" for t, g in CASES]


def _geometry(module):
    return (module.in_channels, module.out_channels, module.kernel_size[0],
            module.stride[0], module.padding[0])


def test_cases_are_the_models_layers():
    trunk = [m for m in conv_trunk() if isinstance(m, nn.Conv2d)]
    hallucinate = [m for m in Decoder(latent_size=8).hallucinate
                   if isinstance(m, nn.ConvTranspose2d)]
    assert [_geometry(m) for m in trunk] == [g[:5] for g in TRUNK]
    assert [_geometry(m) for m in hallucinate] == [g[:5] for g in HALLUCINATE]


def _torch_layer(transposed, geometry, bias=False, dtype=torch.float32, seed=0):
    c_in, c_out, k, s, p, _ = geometry
    torch.manual_seed(seed)
    cls = nn.ConvTranspose2d if transposed else nn.Conv2d
    return cls(c_in, c_out, k, s, p, bias=bias).to(dtype)


def _input(geometry, batch=2, dtype=torch.float32, seed=1):
    c_in, side = geometry[0], geometry[5]
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.normal(size=(batch, c_in, side, side)), dtype=dtype)


@pytest.mark.parametrize("transposed, geometry", CASES, ids=IDS)
def test_plain_weight_grad_matches_autograd(transposed, geometry):
    """In float64, the plain version (through the wrapper's CPU dispatch)
    equals autograd's weight gradient to rounding."""
    ref = _torch_layer(transposed, geometry, dtype=torch.float64)
    x = _input(geometry, dtype=torch.float64)
    y = ref(x)
    g = torch.tensor(np.random.default_rng(2).normal(size=y.shape), dtype=torch.float64)
    y.backward(g)
    k, s, p = geometry[2:5]
    pair = (g, x) if transposed else (x, g)
    got = kernels.conv_wgrad_f32(*pair, k, s, p)
    assert got.shape == ref.weight.shape
    torch.testing.assert_close(got, ref.weight.grad, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("transposed, geometry", CASES, ids=IDS)
def test_layer_forward_and_input_grad_are_unchanged(transposed, geometry, bias):
    """The float32 layer through ``_ConvF32`` against torch's own layer with
    the same weights: a convolution's forward, a transposed one's input
    gradient (``conv_fprop_f32``, on the CPU torch's convolution) and the
    bias gradient bit for bit (a biased convolution's forward against torch's
    convolution without bias plus the bias, as the layer adds it after the
    kernel); the weight gradient, a convolution's input gradient and a
    transposed one's forward (``conv_wgrad_f32`` and ``conv_dgrad_f32``) to
    float32 rounding, relative to the largest element. The output gradient is
    a permuted view, as the decoders' last layer receives it (NCHW ->
    NHWC)."""
    c_in, c_out, k, s, p, _ = geometry
    ref = _torch_layer(transposed, geometry, bias=bias)
    cls = layers.ConvTranspose2d if transposed else layers.Conv2d
    port = cls(c_in, c_out, k, s, p, bias=bias)
    port.load_state_dict(ref.state_dict())
    x_ref = _input(geometry).requires_grad_(True)
    x_port = x_ref.detach().clone().requires_grad_(True)
    y_ref, y_port = ref(x_ref), port(x_port)
    nhwc = np.random.default_rng(3).normal(size=y_ref.permute(0, 2, 3, 1).shape)
    g = torch.tensor(nhwc, dtype=torch.float32).permute(0, 3, 1, 2)
    y_ref.backward(g)
    y_port.backward(g)
    forward, input_grad = (y_port.detach(), y_ref.detach()), (x_port.grad, x_ref.grad)
    # a transposed convolution's forward is the data-gradient kernel's sum
    kernel_made, torch_made = (forward, input_grad) if transposed else (input_grad, forward)
    if bias and not transposed:
        with torch.no_grad():
            biased = torch.nn.functional.conv2d(x_ref, ref.weight, None, s, p)
            torch_made = (y_port.detach(), biased + ref.bias.reshape(-1, 1, 1))
    assert torch.equal(*torch_made)
    if bias:
        assert torch.equal(port.bias.grad, ref.bias.grad)
    # float32 sums of up to 4,096 products, in another order than torch's
    for got, want in (kernel_made, (port.weight.grad, ref.weight.grad)):
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale)


def test_first_layer_skips_the_input_gradient(monkeypatch):
    """An input that needs no gradient (the encoders' images) gets no data
    gradient call; the weight gradient still comes. One that needs it gets
    ``conv_dgrad_f32``'s, and no ``aten.convolution_backward`` (no bias)."""
    calls, dgrad = [], []
    real = torch.ops.aten.convolution_backward

    class Spy:
        def __call__(self, *args):
            calls.append(args[-1])
            return real(*args)

    monkeypatch.setattr(torch.ops.aten, "convolution_backward", Spy())
    real_plain = kernels.conv_dgrad_plain
    monkeypatch.setattr(kernels, "conv_dgrad_plain",
                        lambda *a: dgrad.append(a[0].shape) or real_plain(*a))
    layer = layers.Conv2d(3, 32, 4, 2, 1, bias=False)
    layer(_input(TRUNK[0])).sum().backward()
    assert calls == [] and dgrad == [] and layer.weight.grad is not None
    x = _input(TRUNK[0]).requires_grad_(True)
    layer(x).sum().backward()
    assert calls == [] and dgrad == [(2, 32, 32, 32)] and x.grad is not None


@pytest.mark.parametrize("kw, match", [
    (dict(kernel_size=3), "4 x 4 kernel"),
    (dict(groups=2), "groups 1"),
    (dict(dilation=2), "dilation 1"),
    (dict(stride=3), "stride 1 or 2"),
    (dict(padding=2), "padding 0 or 1"),
    (dict(kernel_size=(4, 2)), "same on both axes"),
], ids=["k3", "groups2", "dilation2", "stride3", "padding2", "k4x2"])
@pytest.mark.parametrize("transposed", [False, True])
def test_geometry_outside_the_kernel_raises(kw, match, transposed):
    """A convolution's forward (``conv_fprop_f32``) and a transposed
    convolution's forward (``conv_dgrad_f32``) raise."""
    args = dict(kernel_size=4, stride=2, padding=1, groups=1, dilation=1) | kw
    cls = layers.ConvTranspose2d if transposed else layers.Conv2d
    layer = cls(4, 8, args.pop("kernel_size"), **args)
    x = torch.zeros((2, 4, 8, 8))
    with pytest.raises(ValueError, match=match):
        layer(x)


def test_non_contiguous_input_raises():
    x, dy = torch.zeros((2, 3, 8, 8)), torch.zeros((2, 5, 4, 4))
    kernels.conv_wgrad_f32(x, dy, 4, 2, 1)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.conv_wgrad_f32(x.transpose(2, 3), dy, 4, 2, 1)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.conv_wgrad_f32(x, dy.transpose(2, 3), 4, 2, 1)
    with pytest.raises(ValueError, match="spatial"):
        kernels.conv_wgrad_f32(x, torch.zeros((2, 5, 5, 5)), 4, 2, 1)


def test_cpu_path_launches_nothing(monkeypatch):
    monkeypatch.setattr(kernels.conv_wgrad_f32, "launches", 0)
    monkeypatch.setattr(kernels.conv_dgrad_f32, "launches", 0)
    layer = layers.ConvTranspose2d(8, 4, 4, 2, 1, bias=False)
    layer(torch.randn(2, 8, 4, 4)).sum().backward()
    layer = layers.Conv2d(8, 4, 4, 2, 1, bias=False)
    layer(torch.randn(2, 8, 8, 8, requires_grad=True)).sum().backward()
    assert kernels.conv_wgrad_f32.launches == kernels.conv_dgrad_f32.launches == 0


def _spy_function(monkeypatch):
    calls = []
    real = layers._ConvF32.apply

    def apply(*args):
        calls.append(args[3])           # transposed
        return real(*args)

    monkeypatch.setattr(layers._ConvF32, "apply", apply)
    return calls


def _step(policy, b=2, t=2):
    cfg = ProblemConfig(problem_type="dyn_modeling", model_name="cnn-mvae",
                        input_type="visuotactile", use_pose=True, latent_size=16,
                        batchsize=b, noise_free=True, compute_dtype=policy)
    model = setup_model("cnn-mvae", cross_modal=True, device="cpu", latent_size=16,
                        use_pose=True, dropout_rate=0.0, compute_dtype=policy)
    state = create_train_state(model, make_optimizer(cfg, model.parameters()))
    rng = np.random.default_rng(0)
    f = lambda *s: rng.uniform(size=s).astype(np.float32)  # noqa: E731
    batch = {"visual": f(b, t, 64, 64, 3), "tactile": f(b, t, 64, 64, 3),
             "pose": f(b, t, 7), "avail": np.ones((b, t, 2), np.float32),
             "final_visual": f(b, 64, 64, 3), "final_tactile": f(b, 64, 64, 3),
             "final_pose": f(b, 7), "seg": np.ones((b, t, 64, 64, 3), np.float32)}
    make_train_step(cfg, device="cpu")(state, batch, torch.Generator(), 1.0)


def test_float32_dyn_step_takes_sixteen_weight_gradients(monkeypatch):
    """Two encoders and two decoders of four convolutions each; the decoders
    run their subsets in one call."""
    calls = _spy_function(monkeypatch)
    plain = []
    real = kernels.conv_wgrad_plain
    monkeypatch.setattr(kernels, "conv_wgrad_plain",
                        lambda *a: plain.append(a[0].shape) or real(*a))
    _step("float32")
    assert calls == [False] * 8 + [True] * 8
    assert len(plain) == 16


@pytest.mark.parametrize("policy", ["bfloat16", "bfloat16_full"])
def test_bf16_policies_do_not_enter_the_function(monkeypatch, policy):
    calls = _spy_function(monkeypatch)
    _step(policy)
    assert calls == []


def test_evaluation_computes_no_weight_gradient(monkeypatch):
    """Without gradients (evaluation, serving) the layer is the forward
    (``conv_fprop_f32``, on the CPU torch's call) and nothing else."""
    plain = []
    real = kernels.conv_wgrad_plain
    monkeypatch.setattr(kernels, "conv_wgrad_plain",
                        lambda *a: plain.append(a) or real(*a))
    ref = _torch_layer(False, TRUNK[1])
    layer = layers.Conv2d(32, 64, 4, 2, 1, bias=False)
    layer.load_state_dict(ref.state_dict())
    with torch.no_grad():
        assert torch.equal(layer(_input(TRUNK[1])), ref(_input(TRUNK[1])))
    assert plain == []
