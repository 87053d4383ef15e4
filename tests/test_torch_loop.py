"""The port's training loop, checkpoints and CLIs on the CPU
(``mmdyn_tpu_torch.train.loop``, ``train/checkpoint.py``, ``cli/``), against
the JAX package's run layout, on a small synthetic compiled corpus."""

import json
import pickle

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
