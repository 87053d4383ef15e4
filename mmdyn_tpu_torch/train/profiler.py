"""Step timing and tracing (port of ``mmdyn_tpu/train/profiler.py``).

``StepTimer`` marks step boundaries without waiting for the device and
waits only when read; ``trace(logdir)`` records a ``torch.profiler`` trace
of the enclosed block (the loop traces one epoch) into ``logdir``.

``Tracer`` is the training loop's recorder: one ``EpochRecord`` for each
training epoch, with spans that tile the epoch and counters taken at their
boundaries, kept in the process-wide ``Tracer.epochs`` (the last
``EPOCHS_KEPT``). Each span is also a profiler range of its own name, so a
``torch.profiler`` trace of the epoch (``trace``) places the spans on the
device trace's clock.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import itertools
import time
from array import array
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from mmdyn_tpu_torch.utils.device import resolve_device

EPOCHS_KEPT = 1024
# the spans of a training epoch, in the order they first open
SPAN_NAMES = ("train.epoch_start", "train.loader_wait", "train.step", "train.read_back",
              "train.log")
EPOCH_START, LOADER_WAIT, STEP, READ_BACK, LOG = range(len(SPAN_NAMES))


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """Profile the enclosed block when ``logdir`` is set: host and, where
    there is a card, device activity, written as a Chrome trace
    (``trace.json``, for Perfetto or chrome://tracing)."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))


class StepTimer:
    """Step-time statistics between marks.

    On the card each mark records a CUDA event on the current stream, so
    marking never waits; the first read waits for the last event and takes
    the device's time between marks. On the CPU a mark reads the host clock.
    ``device`` is the card unless told otherwise (``resolve_device``).
    """

    def __init__(self, device=None):
        self.cuda = resolve_device(device).type == "cuda"
        self.reset()

    def reset(self):
        self._marks = []
        self._times = None

    def mark(self):
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self._marks.append(event)
        else:
            self._marks.append(time.perf_counter())
        self._times = None

    def _step_times(self):
        """Seconds between consecutive marks."""
        if self._times is None:
            m = self._marks
            if self.cuda and m:
                m[-1].synchronize()
                self._times = [a.elapsed_time(b) / 1e3 for a, b in zip(m, m[1:])]
            else:
                self._times = [b - a for a, b in zip(m, m[1:])]
        return self._times

    @property
    def mean_step_time(self) -> float:
        t = self._step_times()
        return sum(t) / len(t) if t else 0.0

    @property
    def min_step_time(self) -> float:
        t = self._step_times()
        return min(t) if t else 0.0

    def frames_per_sec(self, batch_size: int) -> float:
        mt = self.mean_step_time
        return batch_size / mt if mt > 0 else 0.0


class Span(NamedTuple):
    """One span: host nanoseconds of ``time.perf_counter_ns``, the step's
    index in its epoch where there is one, and ``parent``, the ``id`` of
    its epoch record."""
    name: str
    start_ns: int
    end_ns: int
    epoch: int
    step: Optional[int]
    parent: int


class EpochRecord:
    """One call of the training loop's epoch: ``steps`` the step calls it
    made, ``rows`` the rows each trains, ``profiled`` whether a torch
    profiler was running when it began, its spans (``spans``) and its
    counters: Python's collections by generation (``gc_collections``) and
    the nanoseconds they paused (``gc_pause_ns``), and the device
    allocator's ``cudaMalloc`` calls (``device_allocs``; None off the card).

    The spans tile the epoch, so they are kept as their boundaries: span
    ``i`` runs from ``_bounds[i]`` to ``_bounds[i + 1]``."""

    _ids = itertools.count()

    def __init__(self, epoch: int, rows: int, profiled: bool):
        self.id = next(self._ids)
        self.epoch, self.rows, self.profiled = epoch, rows, profiled
        self.steps = 0
        self.gc_collections = [0, 0, 0]
        self.gc_pause_ns = 0
        self.device_allocs: Optional[int] = None
        self._bounds = array("q")
        self._names = array("B")
        self._steps = array("q")      # -1: no step

    def _open(self, name: int, step: Optional[int], now: int):
        self._bounds.append(now)
        self._names.append(name)
        self._steps.append(-1 if step is None else step)

    @property
    def spans(self):
        b = self._bounds
        return [Span(SPAN_NAMES[n], b[i], b[i + 1], self.epoch, None if s < 0 else s, self.id)
                for i, (n, s) in enumerate(zip(self._names, self._steps)) if i + 1 < len(b)]

    def span_ns(self, name: str) -> int:
        """Nanoseconds in the spans named ``name``."""
        code, b = SPAN_NAMES.index(name), self._bounds
        return sum(b[i + 1] - b[i] for i, n in enumerate(self._names)
                   if n == code and i + 1 < len(b))


class Tracer:
    """The training loop's recorder, one a ``Problem``: it owns the
    ``StepTimer`` (``timer``) and marks it at the steps and the read-back.

    ``epoch`` opens an epoch's record and its first span,
    ``train.epoch_start``; each of ``step``, ``loader_wait``, ``read_back``
    and ``log`` ends the open span and opens the one of its name, and the
    record closes on leaving ``epoch``. Each span is a
    ``_RecordFunctionFast`` range too (no range for the whole epoch: a
    trace names an idle gap after its outermost range). While an epoch is
    open a ``gc.callbacks`` hook counts the collector's work. Records go to
    ``Tracer.epochs``, process-wide, as the kernels' launch counters are.
    """

    epochs: collections.deque = collections.deque(maxlen=EPOCHS_KEPT)

    def __init__(self, device=None):
        self.timer = StepTimer(device)
        self._record: Optional[EpochRecord] = None
        self._range = None
        self._allocs0 = None
        self._gc_t0 = None

    @contextlib.contextmanager
    def epoch(self, epoch: int, rows: int):
        record = EpochRecord(epoch, rows, torch.autograd._profiler_enabled())
        self._record = record
        self._begin(EPOCH_START, None)
        self._allocs0 = self._device_allocs()
        gc.callbacks.append(self._on_gc)
        self.timer.reset()
        try:
            yield record
        finally:
            gc.callbacks.remove(self._on_gc)
            now = time.perf_counter_ns()
            self._range.__exit__(None, None, None)
            self._range = self._record = self._gc_t0 = None
            record._bounds.append(now)
            Tracer.epochs.append(record)

    def step(self, index: int):
        """The step ``index`` of the epoch is called."""
        self._begin(STEP, index)
        self._record.steps += 1
        self.timer.mark()

    def loader_wait(self, index: int):
        """The loop waits for the batch of step ``index``."""
        self._begin(LOADER_WAIT, index)

    def read_back(self):
        self._begin(READ_BACK, None)
        self.timer.mark()

    def log(self):
        """After the read-back's wait: the allocator's count is read with no
        wait of its own."""
        allocs = self._device_allocs()
        if allocs is not None:
            self._record.device_allocs = allocs - self._allocs0
        self._begin(LOG, None)

    def _begin(self, name: int, step: Optional[int]):
        now = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        self._record._open(name, step, now)
        self._range = torch._C._profiler._RecordFunctionFast(SPAN_NAMES[name])
        self._range.__enter__()

    def _device_allocs(self):
        if not self.timer.cuda:
            return None
        # the nested form: the flat one costs about 0.16 ms a call on the card
        return torch.cuda.memory_stats_as_nested_dict().get("num_device_alloc")

    def _on_gc(self, phase, info):
        # may run on the prefetch thread, as the epoch closes
        now = time.perf_counter_ns()
        if phase == "start":
            self._gc_t0 = now
            return
        t0, record = self._gc_t0, self._record
        if t0 is not None and record is not None:
            record.gc_pause_ns += now - t0
            record.gc_collections[info["generation"]] += 1
        self._gc_t0 = None
