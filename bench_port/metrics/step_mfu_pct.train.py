"""The training step's share of the chip's peak: the model operations of
every step in the run's window (``counts/model.py``: the convolutions',
transposed convolutions' and linear layers' MACs x 2, x 3 for the
backward, the decoders once per scored subset), over the window's wall
seconds times the published peak of the configuration's precision
(``counts/peaks.py``). The untraced window: the profiler slows a
host-bound loop."""


def read(ctx):
    if ctx.window_steps == 0:
        return None
    flops = ctx.window_steps * ctx.rows * ctx.counts.step_flops_per_row(ctx.latent)
    return 100.0 * flops / (ctx.window_s * ctx.peak_flops)
