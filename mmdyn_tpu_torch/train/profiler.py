"""Step timing and tracing (port of ``mmdyn_tpu/train/profiler.py``).

``StepTimer`` marks step boundaries without waiting for the device and
waits only when read; ``trace(logdir)`` records a ``torch.profiler`` trace
of the enclosed block (the loop traces one epoch) into ``logdir``.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Optional

import torch

from mmdyn_tpu_torch.utils.device import resolve_device


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
