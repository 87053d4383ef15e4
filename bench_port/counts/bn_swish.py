"""Bytes of the cnn-mvae's BatchNorm + swish activations in a training step,
counted from a configuration's shapes alone.

Every activation that a BatchNorm followed by swish takes:
* each image encoder, once a row: the outputs of the three convolutions
  after the first (the first convolution's swish and the FC's have no
  BatchNorm before them);
* each image decoder, once a row of each subset it scores: the outputs of
  every transposed convolution but the last.

Each element is counted as its inputs read once and its output written
once, in float32: x read and y written forward, the output's gradient and x
read and dx written backward, 20 bytes.
"""

from __future__ import annotations

from bench_port.counts.model import BOTTLENECK, DECODER_DECONVS, ENCODER_CONVS, IMAGE
from bench_port.reference.model import TAC_SUBSETS, VIS_SUBSETS

BYTES_PER_ELEMENT = 4 * (2 + 3)         # forward x, y; backward g, x, dx


def _conv_out(size, k, stride, pad):
    return (size + 2 * pad - k) // stride + 1


def _deconv_out(size, k, stride, pad):
    return (size - 1) * stride - 2 * pad + k


def encoder_elements():
    """One image encoder, one row: the outputs of every convolution but the
    first."""
    total, size = 0, IMAGE
    for i, (_, c_out, k, s, p) in enumerate(ENCODER_CONVS):
        size = _conv_out(size, k, s, p)
        total += c_out * size * size if i else 0
    return total


def decoder_elements():
    """One image decoder, one row of one subset: every transposed
    convolution's output but the last (the logits)."""
    total, size = 0, BOTTLENECK[1]
    for _, c_out, k, s, p in DECODER_DECONVS[:-1]:
        size = _deconv_out(size, k, s, p)
        total += c_out * size * size
    return total


def step_elements(rows):
    """Both image encoders once, each image decoder once per subset it
    scores."""
    return rows * (2 * encoder_elements()
                   + (len(VIS_SUBSETS) + len(TAC_SUBSETS)) * decoder_elements())


def step_bytes(rows):
    return BYTES_PER_ELEMENT * step_elements(rows)
