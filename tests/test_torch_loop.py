"""The port's training loop, checkpoints and CLIs on the CPU
(``mmdyn_tpu_torch.train.loop``, ``train/checkpoint.py``, ``cli/``), against
the JAX package's run layout, on a small synthetic compiled corpus."""

import json
import os
import pickle
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from mmdyn_tpu.problems.base import ProblemConfig as JaxConfig
from mmdyn_tpu.train.loop import Problem as JaxProblem

from mmdyn_tpu_torch.cli import evaluate as cli_evaluate
from mmdyn_tpu_torch.cli import main as cli_main
from mmdyn_tpu_torch.data.compile import COMPILED_NAME
from mmdyn_tpu_torch.data.synthetic import make_compiled_arrays
from mmdyn_tpu_torch.problems import ProblemConfig
from mmdyn_tpu_torch.train.checkpoint import (latest_checkpoint, restore_checkpoint,
                                              save_checkpoint)
from mmdyn_tpu_torch.train.loop import Problem
from mmdyn_tpu_torch.train.profiler import StepTimer

# 24 sequences: train 19 (4 batches of 4), test 4 (1 batch)
N_SEQ = 24
VAE = dict(problem_type="seq_modeling", model_name="cnn-vae", input_type="visual",
           latent_size=8, batchsize=4, num_epochs=2, annealing_epochs=2)
MVAE = dict(VAE, model_name="cnn-mvae", input_type="visuotactile", use_pose=True)


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    root = tmp_path_factory.mktemp("ds")
    make_compiled_arrays(root / COMPILED_NAME, n_sequences=N_SEQ, seq_length=2, seed=1)
    return root


def _problem(ds, tmp_path, name="run", **kw):
    cfg = ProblemConfig(**dict(MVAE, **kw.pop("cfg", {})))
    return Problem(cfg, ds, log_dir=str(tmp_path / name), device="cpu",
                   tensorboard=False, **kw)


def _tags(log_dir):
    with open(log_dir / "tensorboard" / "metrics.jsonl") as f:
        return {json.loads(line)["tag"] for line in f}


def test_problem_run_layout_matches_jax(ds, tmp_path):
    """Two epochs: the files of a JAX run, ``norms.json`` with the same keys
    and values, ``metrics.jsonl`` with the same tags, and the checkpoints."""
    jp = JaxProblem(JaxConfig(**VAE), ds, log_dir=str(tmp_path / "jax"), tensorboard=False)
    jp.train()
    tp = Problem(ProblemConfig(**VAE), ds, log_dir=str(tmp_path / "torch"), device="cpu",
                 tensorboard=False)
    results = tp.train()
    assert len(results["Loss/train_epoch"]) == 2 and all(np.isfinite(results["Loss/train_epoch"]))
    for name in ("norms.json", "results.pkl"):
        assert (tp.log_dir / name).exists()
    with open(tp.log_dir / "norms.json") as f, open(jp.log_dir / "norms.json") as g:
        assert json.load(f) == json.load(g)
    assert _tags(tp.log_dir) == _tags(jp.log_dir)
    with open(tp.log_dir / "results.pkl", "rb") as f:
        assert sorted(pickle.load(f)) == sorted(results)
    ckpts = sorted(p.name for p in tp.checkpoint_dir.iterdir())
    assert "latest" in ckpts and any(c.startswith("epoch_") for c in ckpts)
    assert latest_checkpoint(tp.checkpoint_dir).name == "latest"


def _final(problem):
    return {k: v.clone() for k, v in problem.state.model.state_dict().items()}


def _assert_same_run(a_params, a_val, b_params, b_val):
    assert a_val == b_val
    for name in a_params:
        assert torch.equal(a_params[name], b_params[name]), name


@pytest.fixture(scope="module")
def golden(ds, tmp_path_factory):
    """An uninterrupted 3-epoch cnn-mvae run with dropout and noise on."""
    p = _problem(ds, tmp_path_factory.mktemp("golden"), cfg=dict(num_epochs=3))
    logs = p.train()
    return _final(p), logs["Loss/validation_epoch"], p.generator.get_state()


def test_resume_is_bit_identical(ds, tmp_path, golden):
    """One epoch, then ``resume`` to three: the same parameters, validation
    losses and generator state as the uninterrupted run."""
    first = _problem(ds, tmp_path, cfg=dict(num_epochs=1))
    val = first.train()["Loss/validation_epoch"]
    second = _problem(ds, tmp_path, cfg=dict(num_epochs=3), resume=True)
    assert second._start_epoch == 1
    val += second.train()["Loss/validation_epoch"]
    _assert_same_run(_final(second), val, golden[0], golden[1])
    assert torch.equal(second.generator.get_state(), golden[2])


def test_stop_mid_epoch_then_resume_is_bit_identical(ds, tmp_path, golden):
    """A stop requested after optimizer step 6 (mid-epoch 1 of 4 steps per
    epoch) saves ``latest`` at that step; the resumed run replays the rest of
    epoch 1 and ends as the uninterrupted run does."""
    first = _problem(ds, tmp_path, cfg=dict(num_epochs=3))
    step, count = first.train_step, [0]

    def stopping_step(*a):
        out = step(*a)
        count[0] += 1
        if count[0] == 6:
            first._stop_requested = True
        return out

    first.train_step = stopping_step
    val = first.train()["Loss/validation_epoch"]
    assert first._preempted and len(val) == 1
    second = _problem(ds, tmp_path, cfg=dict(num_epochs=3), resume=True)
    assert (second._start_epoch, second._skip_batches) == (1, 2)
    val += second.train()["Loss/validation_epoch"]
    _assert_same_run(_final(second), val, golden[0], golden[1])


def test_checkpoint_round_trip(ds, tmp_path):
    p = _problem(ds, tmp_path, cfg=dict(num_epochs=1))
    p.train()
    gen = torch.Generator().manual_seed(5)
    torch.rand(3, generator=gen)
    path = save_checkpoint(tmp_path, p.state, 4, 1.5, name="snap", generator=gen,
                           batch_in_epoch=2)
    q = _problem(ds, tmp_path, name="other", cfg=dict(num_epochs=1))
    assert q.state.step == 0
    epoch, best, gen_state, batch = restore_checkpoint(path, q.state)
    assert (epoch, best, batch, q.state.step) == (4, 1.5, 2, p.state.step)
    assert torch.equal(gen_state, gen.get_state())
    _assert_same_run(_final(q), 0, _final(p), 0)
    for a, b in zip(q.state.optimizer.state.values(), p.state.optimizer.state.values()):
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_cli_train_then_evaluate(ds, tmp_path):
    """JAX tests/test_train.py:436 and :495: train through the CLI, then
    evaluate the run through the evaluation CLI."""
    problem = cli_main.main([
        "--problem-type", "seq_modeling", "--model-name", "cnn-vae",
        "--input-type", "visual", "--dataset-path", str(ds), "--batchsize", "2",
        "--num-epochs", "1", "--latent-size", "8", "--logs-root", str(tmp_path / "logs"),
        "--no-tensorboard", "--save-name", "smoke", "--platform", "cpu"])
    assert problem.log_dir.name.startswith("smoke")
    for name in ("problem.pkl", "results.pkl", "norms.json", "checkpoint/latest",
                 "checkpoint/epoch_0"):
        assert (problem.log_dir / name).exists(), name
    metrics = cli_evaluate.main(["--run", str(problem.log_dir), "--dataset-path", str(ds),
                                 "--batchsize", "2", "--n-samples", "4", "--platform", "cpu"])
    assert np.isfinite(metrics["test_loss_total"]) and metrics["epoch"] == 0
    plot = problem.log_dir / "plot"
    assert (plot / "eval_metrics.json").exists() and (plot / "recon.png").exists()
    assert (plot / "samples_visual.png").exists()


def test_cli_conditional_mvae_bf16_and_evaluate(tmp_path):
    """A conditional cnn-mvae on a corpus with a shock condition, under
    ``--bf16-full`` and ``--remat``; evaluation writes both modalities' grids
    and samples sized to ``--n-samples``."""
    make_compiled_arrays(tmp_path / "ds" / COMPILED_NAME, n_sequences=12, seq_length=2,
                         with_shock=True, seed=2)
    problem = cli_main.main([
        "--model-name", "cnn-mvae", "--input-type", "visuotactile", "--conditional",
        "--dataset-path", str(tmp_path / "ds"), "--batchsize", "2", "--num-epochs", "1",
        "--latent-size", "8", "--logs-root", str(tmp_path / "logs"), "--no-tensorboard",
        "--bf16-full", "--remat", "--platform", "cpu"])
    assert problem.cfg.compute_dtype == "bfloat16_full" and problem.cfg.remat
    assert problem.cfg.condition_dim == 1
    with open(problem.log_dir / "norms.json") as f:
        assert json.load(f)["compute_dtype"] == "bfloat16_full"
    metrics = cli_evaluate.main(["--run", str(problem.log_dir), "--batchsize", "2",
                                 "--n-samples", "3", "--platform", "cpu"])
    assert np.isfinite(metrics["test_loss_total"])
    names = {p.name for p in (problem.log_dir / "plot").iterdir()}
    assert {"recon_visual.png", "recon_tactile.png", "samples_visual.png",
            "samples_tactile.png"} <= names


def test_cli_devices(ds, tmp_path, monkeypatch):
    """Without ``--platform cpu`` the CLI wants the card; ``--num-devices``
    beyond the visible cards is an error naming both counts, before any
    process starts (no fallback to fewer)."""
    argv = ["--dataset-path", str(ds), "--logs-root", str(tmp_path)]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="--num-devices 2 asks for 2 CUDA devices, "
                                           "but 1 is visible"):
        cli_main.main(argv + ["--num-devices", "2"])
    assert not list(tmp_path.iterdir())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main.main(argv)


def test_empty_train_split_fails_loudly(tmp_path):
    """JAX tests/test_train.py:426: a batch larger than the train split means
    zero optimizer steps, which is an error."""
    make_compiled_arrays(tmp_path / "ds" / COMPILED_NAME, n_sequences=5, seq_length=2)
    with pytest.raises(ValueError, match="train split"):
        Problem(ProblemConfig(**dict(VAE, batchsize=64)), tmp_path / "ds",
                logs_root=str(tmp_path / "logs"), device="cpu", tensorboard=False)


class _Board:
    """Stands in for TensorBoard's SummaryWriter: records what is logged."""

    def __init__(self):
        self.tags = []

    def __getattr__(self, name):
        def record(tag=None, *a, **k):
            self.tags.append((name, tag if isinstance(tag, str) else None))
        return record


def test_images_samples_figures_and_trace(ds, tmp_path):
    """With TensorBoard on: reconstruction panels, prior samples and, with
    ``vis_pose``, the pose triad figures; with a profile directory, a trace
    of epoch 1."""
    p = _problem(ds, tmp_path, vis_pose=True, profile_dir=str(tmp_path / "prof"))
    p.writer._tb = _Board()
    p.train()
    logged = {tag for _, tag in p.writer._tb.tags}
    assert {"Output_img/validation_visual", "Output_img/validation_tactile",
            "Samples/latent_space_visual", "Pose_validation/input",
            "Pose_validation/output_vs_target"} <= logged
    assert (tmp_path / "prof" / "trace.json").exists()


def test_step_timer_on_the_cpu():
    t = StepTimer("cpu")
    assert t.mean_step_time == 0.0 and t.frames_per_sec(4) == 0.0
    for _ in range(3):
        t.mark()
    assert t.mean_step_time > 0
    assert t.frames_per_sec(4) == pytest.approx(4 / t.mean_step_time)


class TestPreemption:
    """JAX tests/test_train.py::TestPreemption on the port: a real ``cli.main``
    process is sent SIGTERM mid-run, and its ``--resume`` run ends with the
    final parameters and optimizer state of an uninterrupted run bit for bit,
    its replayed epochs' validation losses and its steps' losses equal. The
    corpus is the JAX test's (10 sequences x 2 frames, seed 0, 3 epochs); the
    model the flagship's at latent 8, batch 2 (4 steps an epoch): its epochs
    leave the signal most of a second to land in."""

    ARGV = ["-m", "mmdyn_tpu_torch.cli.main", "--problem-type", "seq_modeling",
            "--model-name", "cnn-mvae", "--input-type", "visuotactile", "--use-pose",
            "--latent-size", "8", "--batchsize", "2", "--num-epochs", "3",
            "--annealing-epochs", "2", "--seed", "0", "--no-tensorboard",
            "--platform", "cpu"]
    REPO = Path(__file__).resolve().parents[1]

    def _cmd(self, ds, log_dir, *extra):
        return [sys.executable, *self.ARGV, "--dataset-path", str(ds), "--log-dir",
                str(log_dir), *extra]

    def _run(self, ds, log_dir, *extra):
        out = subprocess.run(self._cmd(ds, log_dir, *extra), cwd=self.REPO,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr + out.stdout
        return out.stdout

    @staticmethod
    def _records(log_dir, tag):
        path = Path(log_dir) / "tensorboard" / "metrics.jsonl"
        if not path.exists():
            return {}
        recs = [json.loads(line) for line in path.read_text().splitlines() if line]
        return {r["step"]: r["value"] for r in recs if r["tag"] == tag}

    @staticmethod
    def _results(log_dir):
        with open(Path(log_dir) / "results.pkl", "rb") as f:
            return pickle.load(f)

    def _sigterm_after_first_step_record(self, ds, log_dir):
        proc = subprocess.Popen(self._cmd(ds, log_dir), cwd=self.REPO,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            deadline = time.monotonic() + 300
            while not self._records(log_dir, "Loss/train_step"):
                assert proc.poll() is None and time.monotonic() < deadline, \
                    proc.communicate()
                time.sleep(0.002)
            os.kill(proc.pid, signal.SIGTERM)
            out, err = proc.communicate(timeout=300)
        finally:
            proc.kill()
        assert proc.returncode == 0, err + out
        return out

    def test_sigterm_kill_resume_matches_uninterrupted(self, tmp_path):
        make_compiled_arrays(tmp_path / "ds" / COMPILED_NAME, n_sequences=10, seq_length=2)
        ds, golden, pre = tmp_path / "ds", tmp_path / "golden", tmp_path / "pre"
        self._run(ds, golden)
        golden_val = self._results(golden)["Loss/validation_epoch"]
        assert len(golden_val) == 3

        out = self._sigterm_after_first_step_record(ds, pre)
        assert "preempted: saved 'latest'" in out, out
        assert len(self._results(pre)["Loss/validation_epoch"]) < 3
        assert (pre / "checkpoint" / "latest").exists()

        out = self._run(ds, pre, "--resume")
        assert "resumed from" in out, out
        val = self._results(pre)["Loss/validation_epoch"]
        assert 1 <= len(val) and val == golden_val[-len(val):]
        steps, golden_steps = (self._records(d, "Loss/train_step") for d in (pre, golden))
        assert len(golden_steps) == 12 and steps == golden_steps
        a, b = (torch.load(d / "checkpoint" / "latest", weights_only=True)
                for d in (golden, pre))
        assert (a["epoch"], a["step"]) == (b["epoch"], b["step"]) == (2, 12)
        for name, v in a["model"].items():
            assert torch.equal(v, b["model"][name]), name
        for i, s in a["optimizer"]["state"].items():
            for k, v in s.items():
                assert torch.equal(torch.as_tensor(v), torch.as_tensor(
                    b["optimizer"]["state"][i][k])), (i, k)
        assert torch.equal(a["generator"], b["generator"])


def test_metric_writer_image_and_histogram_match_jax(tmp_path):
    """``MetricWriter.image`` / ``histogram`` (mmdyn_tpu/train/metrics.py:63,
    :88): the JAX signatures; neither writes a JSONL record, so both runs'
    ``metrics.jsonl`` hold the same records, and TensorBoard gets the same
    image and histogram tags from both."""
    from mmdyn_tpu.train.metrics import MetricWriter as JaxWriter
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    from mmdyn_tpu_torch.train.metrics import MetricWriter

    rng = np.random.default_rng(0)
    image, panel = rng.uniform(size=(8, 6, 3)), rng.uniform(size=(5, 8, 8, 3))
    values = rng.normal(size=200)
    tags = {}
    for name, cls in (("jax", JaxWriter), ("port", MetricWriter)):
        w = cls(tmp_path / name)
        w.scalar("Loss/x", 1.5, 0)
        w.image("Img/one", image, 2)
        w.image_grid("Img/grid", panel, 2, nrow=3)
        w.histogram("Hist/v", values, 3)
        w.close()
        acc = EventAccumulator(str(tmp_path / name)).Reload()
        tags[name] = {k: sorted(acc.Tags()[k]) for k in ("images", "histograms", "scalars")}
    assert tags["port"] == tags["jax"] == {"images": ["Img/grid", "Img/one"],
                                           "histograms": ["Hist/v"], "scalars": ["Loss/x"]}

    def records(name):
        lines = (tmp_path / name / "metrics.jsonl").read_text().splitlines()
        return [{k: v for k, v in json.loads(line).items() if k != "time"} for line in lines]

    assert records("port") == records("jax") == [{"tag": "Loss/x", "value": 1.5, "step": 0}]


def test_step_timer_min_step_time_matches_jax(monkeypatch):
    """``StepTimer.min_step_time`` (mmdyn_tpu/train/profiler.py:56) on the
    host clock: the shortest interval between marks, 0.0 before two marks,
    as the JAX timer reads it."""
    from mmdyn_tpu.train.profiler import StepTimer as JaxTimer

    for timer in (JaxTimer(), StepTimer("cpu")):
        clock = iter([10.0, 11.0, 13.0, 13.5])
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        assert timer.min_step_time == 0.0
        for _ in range(4):
            timer.mark()
        assert timer.min_step_time == 0.5
        assert timer.mean_step_time == pytest.approx(3.5 / 3, abs=0)
        monkeypatch.undo()


def test_plot_pose_writes_the_jax_files(tmp_path):
    """``utils/plots.py::plot_pose`` (mmdyn_tpu/utils/plots.py:113): one
    figure file per whole sequence of ``seq_length`` rows, named as the JAX
    function names them."""
    from mmdyn_tpu.utils.plots import plot_pose as jax_plot_pose

    from mmdyn_tpu_torch.utils.plots import plot_pose

    rng = np.random.default_rng(0)
    out, tgt = rng.uniform(size=(9, 7)), rng.uniform(size=(9, 7))
    for name, fn in (("jax", jax_plot_pose), ("port", plot_pose)):
        (tmp_path / name).mkdir()
        fn(out, tgt, str(tmp_path / name), "pose_val", seq_length=4)
    files = {name: sorted(p.name for p in (tmp_path / name).iterdir())
             for name in ("jax", "port")}
    assert files["port"] == files["jax"] == ["pose_val_0.png", "pose_val_1.png"]
