"""The host ms of an epoch's start in the untraced window: from entering
``Problem._train_epoch`` to its first step call (the loader's iterator, the
prefetch thread's start and the wait for the first batch), the program's
``train.epoch_start`` span, a mean over the window's epochs. The device
waits through it, as the read-back before it drained the queue."""

from bench_port.span_readers import window_epochs


def read(ctx):
    records = window_epochs(ctx)
    if not records:
        return None
    return sum(r.span_ns("train.epoch_start") for r in records) / 1e6 / len(records)
