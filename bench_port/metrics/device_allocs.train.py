"""The caching allocator's ``cudaMalloc`` calls an epoch in the untraced
window: the change over each epoch in ``torch.cuda.memory_stats()``'s
``num_device_alloc``, counted by the program, a mean over the window's
epochs. Nothing off the card."""

from bench_port.span_readers import window_epochs


def read(ctx):
    records = window_epochs(ctx)
    if not records or any(r.device_allocs is None for r in records):
        return None
    return sum(r.device_allocs for r in records) / len(records)
