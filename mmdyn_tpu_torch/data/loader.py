"""Batches of a compiled corpus and their prefetch to the device (port of
``mmdyn_tpu/data/loader.py``).

``BatchLoader`` slices the packed uint8 / float32 arrays into (B, T, ...)
batches in numpy; ``to_device_batch`` moves one to the device, where the
uint8 frames become float32 / 255 (the ToTensor scaling, datasets.py:25);
``device_prefetch`` does that ``size`` batches ahead in a background thread,
on the card through pinned host memory and a side CUDA stream.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from mmdyn_tpu_torch.utils.device import resolve_device

IMAGE_KEYS = ("visual", "tactile", "seg", "final_visual", "final_tactile")
SEQUENCE_KEYS = ("visual", "tactile", "pose", "avail", "shock", "seg")


class BatchLoader:
    """Slices packed per-sequence arrays into (B, T, ...) batches; the JAX
    package's loader, index for index.

    * The last incomplete batch is dropped, as the reference DataLoader's
      ``drop_last`` does (datasets.py:49).
    * ``frames`` gathers only the leading frames of each sequence
      (seq_modeling and regression read frame 0 only, problems.py:648).
    * ``skip`` drops whole keys (the seg masks when the loss is not masked).
    * The shuffle order of pass ``e`` is ``np.random.default_rng([seed, e])``,
      a function of (seed, e) alone: a resumed run pinned to epoch e with
      ``set_epoch`` replays the interrupted epoch's order.
    * With ``process_count`` > 1 every process walks the same global order
      and gathers its contiguous row block of each global batch.
    """

    def __init__(self, arrays: Dict[str, np.ndarray], batch_size: int,
                 shuffle: bool = True, seed: int = 0,
                 frames: Optional[int] = None, skip: tuple = (),
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        self.arrays = {k: v for k, v in arrays.items() if k not in skip}
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.frames = frames
        self.seed = seed
        self._epoch = 0
        self.n_sequences = next(iter(arrays.values())).shape[0]
        self.process_index = 0 if process_index is None else int(process_index)
        self.process_count = 1 if process_count is None else int(process_count)
        if self.process_count > 1 and batch_size % self.process_count:
            raise ValueError(
                f"global batch size {batch_size} must divide evenly across "
                f"{self.process_count} processes")

    def __len__(self):
        """The number of global batches, the same on every process."""
        return self.n_sequences // self.batch_size

    def set_epoch(self, epoch: int):
        """Pin the pass counter: the next iteration shuffles with (seed, epoch)."""
        self._epoch = int(epoch)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(self.n_sequences)
        if self.shuffle:
            np.random.default_rng([self.seed, self._epoch]).shuffle(order)
        self._epoch += 1
        local = self.batch_size // self.process_count
        lo = self.process_index * local
        for b in range(len(self)):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            if self.process_count > 1:
                idx = idx[lo:lo + local]
            # a gather, so a memmapped corpus reads only the pages it needs and
            # every value is a fresh array
            yield {k: v[idx, : self.frames] if self.frames is not None and k in SEQUENCE_KEYS
                   else v[idx] for k, v in self.arrays.items()}


def to_device_batch(batch: Dict[str, np.ndarray], device=None):
    """numpy batch -> tensors on ``device`` (the card unless told otherwise,
    ``utils/device.py::resolve_device``); uint8 image keys travel as uint8
    and become float32 / 255 there. On the card the host arrays are pinned
    first and copied without blocking, on the current stream."""
    device = resolve_device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        if k in IMAGE_KEYS and t.dtype == torch.uint8:
            t = t.to(torch.float32) / 255.0
        out[k] = t
    return out


def device_prefetch(iterator, device=None, size: int = 2):
    """Yield the batches of ``iterator`` on ``device`` (the card unless told
    otherwise; without one the call raises), a background thread preparing
    them ``size`` ahead.

    On the card the thread copies and scales on a side stream and records an
    event; before a batch is handed over, the consumer's stream waits for
    that event, and each tensor is marked as used by the consumer's stream
    (``record_stream``), so the allocator does not hand its memory to the
    side stream again while the step still reads it. An exception in the
    thread is raised in the consumer. Closing the generator early (a
    ``break`` out of the loop, then ``close()``) stops the thread and drops
    the batches it prepared.
    """
    return _prefetch(iterator, resolve_device(device), size)


def _prefetch(iterator, device, size):
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def prepare(batch):
        if stream is None:
            return to_device_batch(batch, device), None
        with torch.cuda.stream(stream):
            out = to_device_batch(batch, device)
            ready = torch.cuda.Event()
            ready.record(stream)
        return out, ready

    queue: collections.deque = collections.deque()
    sem_space = threading.Semaphore(size)
    sem_ready = threading.Semaphore(0)
    done = object()
    stop = threading.Event()        # the consumer has gone

    def producer():
        try:
            for batch in iterator:
                sem_space.acquire()
                if stop.is_set():
                    return
                queue.append(prepare(batch))
                sem_ready.release()
            sem_space.acquire()
            queue.append(done)
        except BaseException as e:  # raised in the consumer, never a hang
            queue.append(e)
        sem_ready.release()

    threading.Thread(target=producer, name="device_prefetch", daemon=True).start()
    try:
        while True:
            sem_ready.acquire()
            item = queue.popleft()
            sem_space.release()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            batch, ready = item
            if ready is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(ready)
                for t in batch.values():
                    t.record_stream(consumer)
            yield batch
    finally:
        stop.set()
        sem_space.release()         # wake a producer waiting for room
        queue.clear()
