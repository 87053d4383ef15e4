"""BatchNorm + swish's share of its byte bound: every BatchNorm + swish
activation of a step, forward and backward
(``counts/bn_swish.py::step_bytes``: x read and y written, the gradient and
x read and dx written, float32), over 3.35 TB/s, over the device time of the
kernels whose names start with ``bn_swish_``; nothing when none ran (the
activations then run as PyTorch's own elementwise passes)."""

from bench_port.counts.bn_swish import step_bytes
from bench_port.train_readers import roofline_pct

KERNELS = ("bn_swish_",)


def read(ctx):
    return roofline_pct(ctx, KERNELS, step_bytes(ctx.rows))
