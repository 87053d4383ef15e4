"""The BatchNorm + swish byte count against hand-worked values and the plain
reference's own activations, and its reader on made-up traces."""

import types

import pytest
import torch

from bench_port import core
from bench_port.counts import bn_swish
from bench_port.counts.peaks import HBM_BYTES_PER_S

ENCODER = 64 * 16 * 16 + 128 * 8 * 8 + 256 * 5 * 5
DECODER = 128 * 8 * 8 + 64 * 16 * 16 + 32 * 32 * 32


def test_counts_by_hand():
    assert ENCODER == 30_976 == bn_swish.encoder_elements()
    assert DECODER == 57_344 == bn_swish.decoder_elements()
    # 2,048 rows: two encoders, 4 + 4 decoder subsets; 20 bytes an element
    assert bn_swish.step_elements(2048) == 2048 * (2 * ENCODER + 8 * DECODER) == 1_066_401_792
    assert bn_swish.step_bytes(2048) == 21_328_035_840


def test_counts_match_the_reference_activations():
    """The elements every BatchNorm of the reference takes (each feeds a
    swish) through one image encoder and one decoder."""
    from bench_port.reference.model import MVAE, BatchNorm

    model = MVAE(256)
    seen = {"n": 0}

    def hook(module, inputs, output):
        seen["n"] += inputs[0].numel()

    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.register_forward_hook(hook)
    with torch.no_grad():
        model.visual_encoder(torch.rand(2, 64, 64, 3))
        assert seen["n"] == 2 * bn_swish.encoder_elements()
        seen["n"] = 0
        model.visual_decoder(torch.rand(2, 256))
        assert seen["n"] == 2 * bn_swish.decoder_elements()


class Trace:
    def __init__(self, kernels):
        self.kernels = kernels

    def device_s(self, match):
        hits = [sec for name, sec in self.kernels.items() if match(name)]
        return sum(hits), len(hits)


@pytest.mark.parametrize("kernels,expected", [
    ({"elementwise_kernel<MulFunctor>": 0.5}, None),          # the parent: nothing to read
    ({"void (anonymous namespace)::bn_swish_dx_kernel<true>(float const*)": 0.02,
      "(anonymous namespace)::bn_swish_stats_merge_kernel(float2 const*)": 0.005,
      "void (anonymous namespace)::wgrad_splitk_kernel<Tile>(Problem)": 1.0},
     100.0 * 2 * 21_328_035_840 / HBM_BYTES_PER_S / 0.025),
])
def test_the_reader(kernels, expected):
    read = core.load_reader("bn_swish_roofline_pct.train")
    ctx = types.SimpleNamespace(trace=Trace(kernels), steps=2, rows=2048)
    got = read(ctx)
    assert got == (None if expected is None else pytest.approx(expected))


def test_the_kernels_are_no_elementwise_family():
    """Named ``bn_swish_``, the kernels count in no family that
    ``elementwise_ms.train`` or ``conv_ms.train`` reads."""
    from bench_port.devtrace import kernel_family

    for name in ("void (anonymous namespace)::bn_swish_norm_kernel<true>(float const*, "
                 "float const*, float const*, float const*, float const*, float*, "
                 "(anonymous namespace)::Segment)",
                 "void (anonymous namespace)::bn_swish_grad_merge_kernel(float2 const*, "
                 "float*, float*, float*, (anonymous namespace)::Segment)"):
        assert kernel_family(name) == "other"
