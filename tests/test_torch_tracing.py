"""The training loop's recorder (``mmdyn_tpu_torch/train/profiler.py::Tracer``)
on the CPU: spans that tile each epoch of ``Problem._train_epoch``, the same
spans as profiler ranges, the collector's counters, the bounded record of
epochs, an epoch cut short, and the rows behind ``Perf/frames_per_sec``."""

import gc
import os
import signal
import time
from contextlib import nullcontext

import pytest
from torch.profiler import ProfilerActivity, profile

from mmdyn_tpu_torch.data.compile import COMPILED_NAME
from mmdyn_tpu_torch.data.synthetic import make_compiled_arrays
from mmdyn_tpu_torch.problems import ProblemConfig
from mmdyn_tpu_torch.train.loop import Problem
from mmdyn_tpu_torch.train.profiler import EPOCHS_KEPT, SPAN_NAMES, Tracer

# 24 sequences of 2 frames: train 19 (4 batches of 4)
VAE = dict(problem_type="seq_modeling", model_name="cnn-vae", input_type="visual",
           latent_size=8, batchsize=4, num_epochs=2, annealing_epochs=2)
STEPS = 4


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    root = tmp_path_factory.mktemp("ds")
    make_compiled_arrays(root / COMPILED_NAME, n_sequences=24, seq_length=2, seed=1)
    return root


def _problem(ds, tmp_path, **cfg):
    return Problem(ProblemConfig(**dict(VAE, **cfg)), ds, log_dir=str(tmp_path / "run"),
                   device="cpu", tensorboard=False)


def _expected_order(steps):
    names = ["train.epoch_start"]
    for _ in range(steps):
        names += ["train.step", "train.loader_wait"]
    return names + ["train.read_back", "train.log"]


def test_spans_tile_each_epoch(ds, tmp_path):
    """The five spans cover the epoch's wall time, measured around the call,
    within 2% or 1 ms; each carries its epoch, its step and its record."""
    p = _problem(ds, tmp_path)
    for epoch in range(2):
        t0 = time.perf_counter_ns()
        p._train_epoch(epoch, 0.5)
        wall = time.perf_counter_ns() - t0
        record = Tracer.epochs[-1]
        spans = record.spans
        assert (record.epoch, record.steps, record.rows) == (epoch, STEPS, 4)
        assert [s.name for s in spans] == _expected_order(STEPS)
        assert set(s.name for s in spans) == set(SPAN_NAMES)
        covered = sum(s.end_ns - s.start_ns for s in spans)
        assert abs(wall - covered) <= max(0.02 * wall, 1e6), (wall, covered)
        assert all(a.end_ns == b.start_ns for a, b in zip(spans, spans[1:]))
        assert {(s.epoch, s.parent) for s in spans} == {(epoch, record.id)}
        assert [s.step for s in spans if s.name == "train.step"] == list(range(STEPS))
        assert [s.step for s in spans if s.name == "train.loader_wait"] == \
            list(range(1, STEPS + 1))
        assert all(s.step is None for s in spans
                   if s.name not in ("train.step", "train.loader_wait"))
        assert record.span_ns("train.step") == sum(
            s.end_ns - s.start_ns for s in spans if s.name == "train.step")
        assert record.device_allocs is None     # no allocator count off the card


def test_spans_are_profiler_ranges_on_its_clock(ds, tmp_path):
    """In a profiled epoch every span has a profiler event of its name, in
    the same order, lasting what the recorder measured within 0.2 ms + 5%."""
    p = _problem(ds, tmp_path)
    p._train_epoch(0, 0.5)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        p._train_epoch(1, 1.0)
    record = Tracer.epochs[-1]
    assert record.profiled
    events = sorted((e for e in prof.events() if e.name in SPAN_NAMES),
                    key=lambda e: e.time_range.start)
    spans = record.spans
    assert [e.name for e in events] == [s.name for s in spans]
    for e, s in zip(events, spans):
        got_ns = 1e3 * (e.time_range.end - e.time_range.start)
        want_ns = s.end_ns - s.start_ns
        assert abs(got_ns - want_ns) <= 0.2e6 + 0.05 * want_ns, (s.name, got_ns, want_ns)


def test_a_collection_in_a_step_is_counted(ds, tmp_path):
    p = _problem(ds, tmp_path)
    step = p.train_step

    def collecting_step(*a):
        gc.collect()
        return step(*a)

    p.train_step = collecting_step
    p._train_epoch(0, 0.5)
    record = Tracer.epochs[-1]
    assert record.gc_collections[2] >= STEPS
    assert record.gc_pause_ns > 0
    assert p._tracer._on_gc not in gc.callbacks     # the hook goes with the epoch


def test_the_record_of_epochs_stays_bounded():
    tracer = Tracer("cpu")
    n = EPOCHS_KEPT + 5
    for epoch in range(n):
        with tracer.epoch(epoch, rows=1):
            tracer.step(0)
    assert len(Tracer.epochs) == EPOCHS_KEPT == Tracer.epochs.maxlen
    assert [r.epoch for r in (Tracer.epochs[0], Tracer.epochs[-1])] == [5, n - 1]
    assert all(r.steps == 1 for r in Tracer.epochs)


def test_an_epoch_stopped_by_sigterm_keeps_its_partial_record(ds, tmp_path):
    """A SIGTERM after the second step: the snapshot is taken there, and the
    epoch's record holds its two steps, then the read-back and the log."""
    p = _problem(ds, tmp_path, num_epochs=3)
    step, calls = p.train_step, [0]

    def signalling_step(*a):
        out = step(*a)
        calls[0] += 1
        if calls[0] == 2:
            # the loop's handler, not the default one that ends the process
            assert callable(signal.getsignal(signal.SIGTERM))
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    p.train_step = signalling_step
    p.train()
    assert p._preempted
    record = Tracer.epochs[-1]
    assert (record.epoch, record.steps) == (0, 2)
    assert [s.name for s in record.spans] == [
        "train.epoch_start", "train.step", "train.loader_wait", "train.step",
        "train.read_back", "train.log"]


def test_an_epoch_that_raises_keeps_its_record(ds, tmp_path):
    p = _problem(ds, tmp_path)
    step, calls = p.train_step, [0]

    def failing_step(*a):
        calls[0] += 1
        if calls[0] == 3:
            raise RuntimeError("step failed")
        return step(*a)

    p.train_step = failing_step
    with pytest.raises(RuntimeError, match="step failed"):
        p._train_epoch(0, 0.5)
    record = Tracer.epochs[-1]
    assert record.steps == 3 and record.spans[-1].name == "train.step"
    assert p._tracer._on_gc not in gc.callbacks


def test_the_profiled_flag_tracks_a_running_profiler():
    tracer = Tracer("cpu")
    flags = []
    for profiled in (False, True, False):
        with profile(activities=[ProfilerActivity.CPU]) if profiled else nullcontext():
            with tracer.epoch(0, rows=1):
                tracer.step(0)
        flags.append(Tracer.epochs[-1].profiled)
    assert flags == [False, True, False]


@pytest.mark.parametrize("problem,rows", [("seq_modeling", 4), ("dyn_modeling", 8)])
def test_frames_per_sec_counts_the_rows_the_step_trains(ds, tmp_path, problem, rows):
    """``Perf/frames_per_sec`` counts B rows a step, B x T for dyn_modeling,
    as the benchmark's ``train_frames_per_s`` does."""
    p = _problem(ds, tmp_path, problem_type=problem)
    p._train_epoch(0, 0.5)
    assert Tracer.epochs[-1].rows == rows
    fps = p._logger_dict["Perf/frames_per_sec"][-1]
    assert fps == pytest.approx(rows / p._tracer.timer.mean_step_time)
