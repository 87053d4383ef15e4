"""The sum-reduced BCE's share of its byte bound: per step two calls (the
visual and the tactile term), each over (4, B, 64, 64, 3) logits in the
activation dtype against a float32 target (``counts/model.py::bce_bytes``),
read once and the sum written once, over the device time of the kernels
that compute it."""

from bench_port.reference.model import TAC_SUBSETS, VIS_SUBSETS
from bench_port.train_readers import roofline_pct

KERNELS = ("bce_partial", "bce_final")


def read(ctx):
    logit = 2 if ctx.policy == "bfloat16_full" else 4
    per_step = (ctx.counts.bce_bytes(len(VIS_SUBSETS), ctx.rows, logit)
                + ctx.counts.bce_bytes(len(TAC_SUBSETS), ctx.rows, logit))
    return roofline_pct(ctx, KERNELS, per_step)
