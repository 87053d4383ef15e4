"""The product of experts and reparameterisation's share of its byte bound:
one call a step over 4 experts and 7 subsets (``counts/model.py::poe_bytes``),
over the device time of the kernel that computes it."""

from bench_port.reference.model import SUBSETS_POSE
from bench_port.train_readers import roofline_pct

KERNELS = ("poe_reparam",)


def read(ctx):
    per_step = ctx.counts.poe_bytes(len(SUBSETS_POSE[0]), len(SUBSETS_POSE), ctx.rows,
                                    ctx.latent)
    return roofline_pct(ctx, KERNELS, per_step)
