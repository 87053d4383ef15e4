"""What the training cells' per-layer readers (``metrics/<name>.train.py``)
share. A reader returns None where it finds nothing to read."""

from bench_port.counts.peaks import HBM_BYTES_PER_S


def family_ms(ctx, family):
    """Device ms a step in the kernels of ``family``
    (``devtrace.kernel_family``) over the traced epochs."""
    if ctx.steps == 0:
        return None
    s = ctx.trace.family_s(family)
    return 1e3 * s / ctx.steps if s > 0 else None


def roofline_pct(ctx, kernels, bytes_per_step):
    """Bytes a step x steps over 3.35 TB/s, against the device time of the
    kernels whose names hold one of ``kernels``; nothing when none ran."""
    if ctx.steps == 0:
        return None
    sec, _ = ctx.trace.device_s(lambda name: any(k in name for k in kernels))
    if sec <= 0:
        return None
    return 100.0 * ctx.steps * bytes_per_step / HBM_BYTES_PER_S / sec
