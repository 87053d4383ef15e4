"""What the training loop's span and counter readers share: the program's
epoch records (``mmdyn_tpu_torch/train/profiler.py``: ``Tracer.epochs``)
of the untraced window. Nothing where the program keeps no records (a
program without the recorder) or where their steps do not add up to the
window's, so that a change to the run's order shows as a missing metric,
not a wrong one."""


def window_epochs(ctx):
    """The records of the window's epochs: the run of unprofiled records
    just before the trailing profiled ones (the traced epochs, which hold at
    least ``ctx.steps`` steps), cut back from its end to exactly
    ``ctx.window_steps`` steps; None where they do not add up."""
    try:
        from mmdyn_tpu_torch.train.profiler import Tracer
    except ImportError:
        return None
    records = list(Tracer.epochs)
    end = len(records)
    while end and records[end - 1].profiled:
        end -= 1
    if ctx.window_steps <= 0 or sum(r.steps for r in records[end:]) < max(ctx.steps, 1):
        return None
    start, steps = end, 0
    while start and steps < ctx.window_steps and not records[start - 1].profiled:
        start -= 1
        steps += records[start].steps
    return records[start:end] if steps == ctx.window_steps else None

