"""The share of a step in which no kernel or copy runs on the device: the
device's busy seconds a step (overlapping intervals merged) in the traced
epochs, against the step period of the untraced window. The profiler slows
the host's launches, not the kernels, so the traced window's own idle
share (``device.busy_s`` / ``window_s``) reads high for a host-bound
loop."""


def read(ctx):
    if ctx.steps == 0 or ctx.window_steps == 0 or ctx.trace.busy_s <= 0:
        return None
    busy_per_step = ctx.trace.busy_s / ctx.steps
    return 100.0 * (1.0 - busy_per_step / (ctx.window_s / ctx.window_steps))
