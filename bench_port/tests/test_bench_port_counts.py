"""The operation and byte counters against hand-worked values, and against
the plain reference's own layers."""

import math

import pytest
import torch

from bench_port import core
from bench_port.counts import model as counts

ENCODER = (32 * 32 * 32 * 3 * 16        # conv 3 -> 32, 64 -> 32 px
           + 16 * 16 * 64 * 32 * 16     # conv 32 -> 64
           + 8 * 8 * 128 * 64 * 16      # conv 64 -> 128
           + 5 * 5 * 256 * 128 * 16     # conv 128 -> 256, k4 s1 p0
           + 6400 * 512 + 2 * 512 * 256)
DECODER = (256 * 6400                   # upsample
           + 5 * 5 * 256 * 128 * 16     # deconv 256 -> 128 from 5 x 5
           + 8 * 8 * 128 * 64 * 16
           + 16 * 16 * 64 * 32 * 16
           + 32 * 32 * 32 * 3 * 16)
POSE_ENCODER = 7 * 512 + 512 * 512 + 2 * 512 * 256
POSE_DECODER = 256 * 512 + 512 * 512 + 512 * 7


def test_layer_counts_by_hand():
    assert ENCODER == 34_996_224 == counts.encoder_macs(256)
    assert DECODER == 33_095_680 == counts.decoder_macs(256)
    assert POSE_ENCODER == counts.pose_encoder_macs(256)
    assert POSE_DECODER == counts.pose_decoder_macs(256)


@pytest.mark.parametrize("cell,rows", [("dyn-f32-b256x8", 2048)])
def test_step_flops_of_each_training_cell(cell, rows):
    _, config, mix, _, _ = core.find_cell(cell)
    latent = config["model"]["latent_size"]
    per_row = 6 * (2 * ENCODER + POSE_ENCODER + 8 * DECODER + 4 * POSE_DECODER)
    assert per_row == 2_021_237_760 == counts.step_flops_per_row(latent)
    t = mix["seq_length"] if config["model"]["problem_type"] == "dyn_modeling" else 1
    assert mix["batch"] * t == rows


@pytest.mark.parametrize("cell,logit_bytes,expected", [
    ("dyn-f32-b256x8", 4, 503_316_484),    # 4 x 2048 x 12288 f32 + target + sum
])
def test_bce_bytes(cell, logit_bytes, expected):
    _, config, mix, _, _ = core.find_cell(cell)
    policy = config["model"]["compute_dtype"]
    assert (2 if policy == "bfloat16_full" else 4) == logit_bytes
    t = mix["seq_length"] if config["model"]["problem_type"] == "dyn_modeling" else 1
    assert counts.bce_bytes(4, mix["batch"] * t, logit_bytes) == expected


@pytest.mark.parametrize("rows,expected", [(512, 75_497_476), (2048, 301_989_892)])
def test_bce_bytes_of_bf16_logits(rows, expected):
    # 4 x B x 12288 bf16 logits + the f32 target + the sum
    assert counts.bce_bytes(4, rows, 2) == expected == 4 * rows * 12288 * 2 + rows * 12288 * 4 + 4


@pytest.mark.parametrize("rows,expected", [(512, 18_874_480), (2048, 75_497_584)])
def test_poe_bytes(rows, expected):
    # (2M + K) planes read and 3K written, float32, plus the (K, M) mask
    assert counts.poe_bytes(4, 7, rows, 256) == expected == 4 * ((8 + 28) * rows * 256 + 28)


def test_counts_match_the_reference_layers():
    """The MACs of every conv, transposed conv and linear layer of one row
    through the reference's encoders and decoders, read from the shapes
    each layer sees."""
    from bench_port.reference.model import MVAE

    model = MVAE(256)
    macs = {"n": 0}

    def hook(module, inputs, output):
        x = inputs[0]
        if isinstance(module, torch.nn.Linear):
            macs["n"] += module.in_features * module.out_features * x.shape[0]
        elif isinstance(module, torch.nn.ConvTranspose2d):
            k = math.prod(module.kernel_size)
            macs["n"] += (x.shape[0] * x.shape[-2] * x.shape[-1] * module.in_channels
                          * module.out_channels * k)
        elif isinstance(module, torch.nn.Conv2d):
            k = math.prod(module.kernel_size)
            macs["n"] += (x.shape[0] * output.shape[-2] * output.shape[-1]
                          * module.in_channels * module.out_channels * k)

    for m in model.modules():
        if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            m.register_forward_hook(hook)
    with torch.no_grad():
        model.visual_encoder(torch.rand(2, 64, 64, 3))
        assert macs["n"] == 2 * counts.encoder_macs(256)
        macs["n"] = 0
        assert model.visual_decoder(torch.rand(2, 256)).shape == (2, 64, 64, 3)
        assert macs["n"] == 2 * counts.decoder_macs(256)
        macs["n"] = 0
        model.pose_encoder(torch.rand(2, 7))
        model.pose_decoder(torch.rand(2, 256))
        assert macs["n"] == 2 * (counts.pose_encoder_macs(256) + counts.pose_decoder_macs(256))
