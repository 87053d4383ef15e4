"""The ms a step that Python's collector paused the process in the untraced
window's training epochs, timed by the program's ``gc.callbacks`` hook
(``gc_pause_ns`` of each epoch record), over the window's steps."""

from bench_port.span_readers import window_epochs


def read(ctx):
    records = window_epochs(ctx)
    if records is None:
        return None
    return sum(r.gc_pause_ns for r in records) / 1e6 / ctx.window_steps
