"""The training loop's span and counter readers (``span_readers.py`` and
the four ``metrics/`` files that read the program's epoch records): what a
traced run reports on the CPU and on the card, and the window's epochs
chosen from the records, or nothing where the steps do not add up."""

import json
import types

import pytest

from bench_port import core, span_readers
from bench_port.tests.test_bench_port_correct import _run_on_card
from bench_port.tests.tiny import run_tiny

SPAN_METRICS = ("epoch_start_ms.train", "loader_wait_ms.train", "gc_ms.train")


def test_a_traced_cpu_run_reports_the_span_metrics():
    result, _ = run_tiny("dyn-f32-b256x8", trace=1)
    got = result["metrics"]
    assert set(SPAN_METRICS) <= set(got)
    assert all(got[m]["unit"] == "ms" and got[m]["value"] >= 0 for m in SPAN_METRICS)
    assert got["epoch_start_ms.train"]["value"] > 0
    # no allocator count off the card
    assert "device_allocs.train" not in got


def _records(steps, profiled):
    return [types.SimpleNamespace(steps=s, profiled=p) for s, p in zip(steps, profiled)]


@pytest.fixture
def fake_epochs(monkeypatch):
    from mmdyn_tpu_torch.train.profiler import Tracer

    def use(records):
        monkeypatch.setattr(Tracer, "epochs", records)
    return use


def test_the_window_is_the_unprofiled_run_before_the_traced_epochs(fake_epochs):
    # warm 2, window 3, traced 2 + hosted 1; 4 steps an epoch
    records = _records([4] * 8, [False] * 5 + [True] * 3)
    fake_epochs(records)
    ctx = types.SimpleNamespace(window_steps=12, steps=8)
    assert span_readers.window_epochs(ctx) == records[2:5]


@pytest.mark.parametrize("steps,profiled,window_steps,traced_steps", [
    ([4] * 8, [False] * 5 + [True] * 3, 10, 8),     # the window cuts an epoch
    ([4] * 8, [False] * 5 + [True] * 3, 24, 8),     # more steps than unprofiled records
    ([4] * 8, [False] * 8, 12, 8),                  # no traced epochs after the window
    ([4] * 8, [False] * 7 + [True], 12, 8),         # traced epochs not profiled
    ([4] * 8, [False] * 5 + [True] * 3, 0, 8),      # an empty window
])
def test_the_window_is_nothing_where_the_steps_do_not_add_up(
        fake_epochs, steps, profiled, window_steps, traced_steps):
    fake_epochs(_records(steps, profiled))
    ctx = types.SimpleNamespace(window_steps=window_steps, steps=traced_steps)
    assert span_readers.window_epochs(ctx) is None
    for name in SPAN_METRICS + ("device_allocs.train",):
        assert core.load_reader(name)(ctx) is None


def test_the_readers_read_the_window_records(fake_epochs):
    from mmdyn_tpu_torch.train.profiler import EPOCH_START, LOADER_WAIT, STEP, EpochRecord

    def record(profiled, allocs):
        r = EpochRecord(0, rows=8, profiled=profiled)
        for name, step, t in ((EPOCH_START, None, 0), (STEP, 0, 2_000_000),
                              (LOADER_WAIT, 1, 3_000_000), (STEP, 1, 3_500_000)):
            r._open(name, step, t)
        r._bounds.append(4_000_000)
        r.steps, r.gc_pause_ns, r.device_allocs = 2, 300_000, allocs
        return r

    fake_epochs([record(False, 9), record(False, 1), record(False, 3), record(True, 0)])
    ctx = types.SimpleNamespace(window_steps=4, steps=2)
    read = {name: core.load_reader(name)(ctx) for name in SPAN_METRICS + (
        "device_allocs.train",)}
    assert read == pytest.approx({"epoch_start_ms.train": 2.0, "loader_wait_ms.train": 0.25,
                                  "gc_ms.train": 0.15, "device_allocs.train": 2.0})


@pytest.mark.card
def test_a_traced_run_on_the_card_reports_all_four(card):
    result = _run_on_card("dyn-f32-b256x8", "--trace", "1")
    assert result["correct"] is True, result["checks"]
    got = result["metrics"]
    assert set(SPAN_METRICS + ("device_allocs.train",)) <= set(got), json.dumps(got)
    assert got["device_allocs.train"]["unit"] == "calls"
