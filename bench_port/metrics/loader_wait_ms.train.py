"""The host ms a step that the loop waits on the prefetch queue for the
next batch after the first of an epoch, the program's ``train.loader_wait``
span over the untraced window's steps."""

from bench_port.span_readers import window_epochs


def read(ctx):
    records = window_epochs(ctx)
    if records is None:
        return None
    return sum(r.span_ns("train.loader_wait") for r in records) / 1e6 / ctx.window_steps
