"""Operations and bytes of the cnn-mvae, counted from a configuration's
shapes alone, whatever implements them.

Multiply-accumulates (MACs) per row, by the usual rule: a convolution does
out_h * out_w * c_in * c_out * k * k, a transposed convolution
in_h * in_w * c_in * c_out * k * k, a linear layer fan_in * fan_out. One
MAC is two operations; a training step counts its forward three times
(the backward computes the data and the weight gradients). Elementwise
work, BatchNorm, PoE and the losses are left out: they are a fraction of a
percent of the operations, and a count that leaves work out can only read
low.
"""

from __future__ import annotations

import math

from bench_port.reference.model import POSE_SUBSETS, TAC_SUBSETS, VIS_SUBSETS

IMAGE = 64
ENCODER_CONVS = ((3, 32, 4, 2, 1), (32, 64, 4, 2, 1), (64, 128, 4, 2, 1),
                 (128, 256, 4, 1, 0))            # (c_in, c_out, k, stride, pad)
DECODER_DECONVS = ((256, 128, 4, 1, 0), (128, 64, 4, 2, 1), (64, 32, 4, 2, 1),
                   (32, 3, 4, 2, 1))
BOTTLENECK = (256, 5, 5)
POSE_ENCODER = (7, 512, 512)                     # then two heads to the latent
POSE_DECODER = (512, 512, 7)                     # from the latent


def _conv_out(size, k, stride, pad):
    return (size + 2 * pad - k) // stride + 1


def _deconv_out(size, k, stride, pad):
    return (size - 1) * stride - 2 * pad + k


def encoder_macs(latent):
    """One image encoder, one row."""
    macs, size = 0, IMAGE
    for c_in, c_out, k, s, p in ENCODER_CONVS:
        size = _conv_out(size, k, s, p)
        macs += size * size * c_in * c_out * k * k
    fc = math.prod(BOTTLENECK)
    return macs + fc * 512 + 2 * 512 * latent


def decoder_macs(latent):
    """One image decoder, one row of one subset."""
    macs, size = latent * math.prod(BOTTLENECK), BOTTLENECK[1]
    for c_in, c_out, k, s, p in DECODER_DECONVS:
        macs += size * size * c_in * c_out * k * k
        size = _deconv_out(size, k, s, p)
    if size != IMAGE:
        raise AssertionError(f"the decoder ends at {size}, not {IMAGE}")
    return macs


def pose_encoder_macs(latent):
    a, b, c = POSE_ENCODER
    return a * b + b * c + 2 * c * latent


def pose_decoder_macs(latent):
    a, b, c = POSE_DECODER
    return latent * a + a * b + b * c


def step_flops_per_row(latent):
    """A training step of the subset ELBO, per input row: both image
    encoders and the pose encoder once, each image decoder once per subset
    it scores, the pose decoder once per pose subset; x 2 x 3."""
    fwd = (2 * encoder_macs(latent) + pose_encoder_macs(latent)
           + (len(VIS_SUBSETS) + len(TAC_SUBSETS)) * decoder_macs(latent)
           + len(POSE_SUBSETS) * pose_decoder_macs(latent))
    return 2 * 3 * fwd


def bce_bytes(subsets, rows, logit_bytes):
    """One sum-reduced BCE over (K, B, 64, 64, 3) logits against a (B, ...)
    float32 target: the logits and the target read once, the float32 sum
    written once."""
    pixels = rows * IMAGE * IMAGE * 3
    return subsets * pixels * logit_bytes + pixels * 4 + 4


def poe_bytes(experts, subsets, rows, latent):
    """PoE and reparameterisation of K subsets of M experts: mu and logvar
    (M, B, D), the (K, M) mask and the (K, B, D) noise read, z, mu and
    logvar (K, B, D) written, all float32."""
    return 4 * ((2 * experts + 4 * subsets) * rows * latent + subsets * experts)
