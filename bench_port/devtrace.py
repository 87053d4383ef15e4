"""The device trace of a traced window, reduced to what the per-layer
readers read: device time by kernel, the device's busy seconds (kernel and
copy intervals merged), and the longest idle gaps by what the host was
doing in them.

``kernel_family`` and the profiling frame are copied from
``chip_smoke.py:913-961`` (``kernel_family``, ``device_profile``), and
``CONV_KERNELS`` from ``chip_smoke.py:293`` (with the complex GEMMs that
float32 FFT convolutions run, ``sm80_xmma_gemm_cf32cf32_...``, which it
missed), so that a change to the program cannot move the yardstick. Device time is summed from the
device's own events (kernels, copies, sets), which also give the busy
intervals; ``device_profile`` read ``key_averages``, where the device-side
mirrors of host annotations (``Optimizer.step#Adam.step``) count as device
time.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

# by kernel name; "gemm_cf32" is the complex GEMM of cuDNN's FFT convolutions
CONV_KERNELS = ("fprop", "dgrad", "wgrad", "fft", "conv", "cgemm", "gemm_cf32")
NO_OP = "host between operations"


def kernel_family(name):
    """chip_smoke.py:913-918, with the convolutions (chip_smoke.py:973-974)
    taken first."""
    if any(c in name.lower() for c in CONV_KERNELS):
        return "conv"
    for key, family in (("Cat", "cat"), ("copy", "copy / cast"), ("reduce", "reduce"),
                        ("index", "index"), ("elementwise", "elementwise")):
        if key in name:
            return family
    return "other"


class Trace:
    """A finished profile: ``window_s`` the host seconds traced,
    ``kernels`` {name: [device seconds, launches]}, ``busy_s``, and the
    host's activity in the idle gaps."""

    def __init__(self, prof, window_s):
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        self.window_s = window_s
        self.kernels = {}
        events = prof.events()
        # the device's own operations: kernels, copies, sets; not the
        # annotations that mirror host ranges on the device's timeline
        dev = [e for e in events if e.device_type == cuda
               and not getattr(e, "is_user_annotation", False)]
        for e in dev:
            k = self.kernels.setdefault(e.name, [0.0, 0])
            k[0] += (e.time_range.end - e.time_range.start) / 1e6
            k[1] += 1
        self.busy_s, self.gaps = _merge([(e.time_range.start, e.time_range.end) for e in dev])
        host = [e for e in events if e.device_type != cuda]
        self.host = (np.array([e.time_range.start for e in host], dtype=np.float64),
                     np.array([e.time_range.end for e in host], dtype=np.float64),
                     [e.name for e in host])

    def device_s(self, match):
        """Device seconds and launches of the kernels whose name ``match``
        accepts."""
        s = n = 0
        for name, (sec, count) in self.kernels.items():
            if match(name):
                s += sec
                n += count
        return s, n

    def family_s(self, family):
        return self.device_s(lambda name: kernel_family(name) == family)[0]

    def top_ops(self, n=10):
        ranked = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:n]
        return [[name[:200], sec] for name, (sec, _) in ranked]

    def idle_gaps(self, n=10, look=50):
        """The idle seconds of the ``look`` longest gaps, summed by what the
        host was doing at each gap's middle (the outermost and the innermost
        host event there), the ``n`` largest."""
        starts, ends, names = self.host
        by = {}
        for lo, hi in sorted(self.gaps, key=lambda g: g[0] - g[1])[:look]:
            mid = 0.5 * (lo + hi)
            on = np.nonzero((starts <= mid) & (ends >= mid))[0]
            if len(on):
                span = ends[on] - starts[on]
                outer, inner = names[on[np.argmax(span)]], names[on[np.argmin(span)]]
                name = outer if outer == inner else f"{outer} > {inner}"
            else:
                name = NO_OP
            by[name] = by.get(name, 0.0) + (hi - lo) / 1e6
        return [[k[:200], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def _merge(intervals):
    """(busy seconds, idle gaps in us) of possibly overlapping intervals."""
    busy, gaps, cur = 0.0, [], None
    for lo, hi in sorted(intervals):
        if cur is None:
            cur = [lo, hi]
        elif lo > cur[1]:
            busy += cur[1] - cur[0]
            gaps.append((cur[1], lo))
            cur = [lo, hi]
        else:
            cur[1] = max(cur[1], hi)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy / 1e6, gaps


@contextlib.contextmanager
def traced(torch, out, cuda=True, host=False):
    """Profile the enclosed block; on leaving, ``out["trace"]`` holds its
    ``Trace``. On a card the device's activity alone, which costs the host
    little, unless ``host`` asks for the host's operations too (which slows
    a host-bound loop: for the idle gaps' attribution only). The block is
    synchronised on both ends so that the window holds its device work."""
    from torch.profiler import ProfilerActivity, profile

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = ([ProfilerActivity.CUDA] if cuda else []) + (
        [ProfilerActivity.CPU] if host or not cuda else [])
    sync()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        yield
        sync()
        window_s = time.perf_counter() - t0
    out["trace"] = Trace(prof, window_s)
