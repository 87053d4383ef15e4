"""The port's CLIs and tools across ranks on the CPU: ``cli.main`` and
``cli.infer`` with ``--num-devices``, a stop on one rank and the resume,
and the ``multihost_smoke`` tool, spawned and launched by hand. The shared
helpers and the rank functions are in ``tests/torch_parallel.py``.
"""

import json

import numpy as np
import pytest
import torch

from mmdyn_tpu_torch.cli import infer
from mmdyn_tpu_torch.cli import main as cli_main
from mmdyn_tpu_torch.data.compile import COMPILED_NAME
from mmdyn_tpu_torch.data.synthetic import make_compiled_arrays
from mmdyn_tpu_torch.parallel import spawn
from mmdyn_tpu_torch.serve import load_exported
from mmdyn_tpu_torch.tools import multihost_smoke
from tests.torch_parallel import TIMEOUT, _serving_inputs, _stop_then_resume
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_ds")
    make_compiled_arrays(root / COMPILED_NAME, n_sequences=24, seq_length=2, seed=1)
    return root


def _losses(run):
    with open(run / "tensorboard" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    return {(r["tag"], r["step"]): r["value"] for r in recs
            if r.get("tag", "").startswith("Loss/")}


def test_cli_two_ranks_match_one_process(corpus, tmp_path):
    """``cli.main --num-devices 2 --platform cpu``: one run directory, one
    set of checkpoints, and the one-process run's losses within rel 1e-5;
    its checkpoint resumes in one process to a third epoch."""
    argv = ["--problem-type", "seq_modeling", "--model-name", "cnn-mvae",
            "--input-type", "visuotactile", "--use-pose", "--dataset-path", str(corpus),
            "--batchsize", "4", "--latent-size", "8", "--annealing-epochs", "2",
            "--no-tensorboard", "--platform", "cpu"]
    one = cli_main.main(argv + ["--num-epochs", "3", "--log-dir", str(tmp_path / "one")])
    run = cli_main.main(argv + ["--num-epochs", "2", "--num-devices", "2",
                                "--logs-root", str(tmp_path / "logs")])
    assert [p.name for p in (tmp_path / "logs").iterdir()] == [run.name]
    assert sorted(p.name for p in (run / "checkpoint").iterdir()) == sorted(
        p.name for p in (tmp_path / "one" / "checkpoint").iterdir() if p.name != "epoch_2")
    for name in ("problem.pkl", "norms.json", "results.pkl"):
        assert (run / name).exists(), name
    want, got = _losses(tmp_path / "one"), _losses(run)
    assert got and got.keys() <= want.keys()
    for key, v in got.items():
        assert v == pytest.approx(want[key], rel=1e-5), key
    resumed = cli_main.main(argv + ["--num-epochs", "3", "--log-dir", str(run), "--resume"])
    assert resumed._start_epoch == 2 and resumed.state.step == 3 * 4
    assert _losses(run)[("Loss/validation_epoch", 2)] == pytest.approx(
        want[("Loss/validation_epoch", 2)], rel=1e-4)


def _write_dump(path, n=4, seed=0):
    """A sim-dump-like sequence (tests/test_torch_serve.py's): visual /
    tactile / seg PNGs and data.json."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    path.mkdir(parents=True)
    for i in range(n):
        for m in ("visual", "tactile"):
            Image.fromarray(rng.integers(0, 256, (96, 128, 3), np.uint8)).save(
                path / f"{m}_{i:04d}.png")
        seg = np.zeros((96, 128), np.uint8)
        seg[20 + i:50, 30:90 - 2 * i] = 3
        Image.fromarray(seg).save(path / f"seg_{i:04d}.png")
    with open(path / "data.json", "w") as f:
        json.dump({"position": rng.uniform(size=(n, 3)).tolist(),
                   "orientation": rng.uniform(-1, 1, size=(n, 4)).tolist()}, f)
    return path


def _pngs(out, prefix):
    from PIL import Image

    return [np.asarray(Image.open(f)).astype(int) for f in sorted(out.glob(f"{prefix}_*.png"))]


def test_infer_cli_two_ranks_match_one_process(corpus, tmp_path):
    """``cli.infer --num-devices 2 --platform cpu``: each rank predicts its
    rows with BatchNorm over both; rank 0 writes the predictions, the
    calibrated rollout and the report of one process (uint8 PNGs at most 1
    count apart); ``--export`` under two ranks writes rank 0's one-device
    artifact, whose outputs equal the one-process artifact's bit for bit."""
    run = cli_main.main(["--problem-type", "seq_modeling", "--model-name", "cnn-mvae",
                         "--input-type", "visuotactile", "--use-pose", "--dataset-path",
                         str(corpus), "--batchsize", "4", "--latent-size", "8",
                         "--num-epochs", "1", "--no-tensorboard", "--platform", "cpu",
                         "--log-dir", str(tmp_path / "run")]).log_dir
    dump = _write_dump(tmp_path / "seq")
    base = ["--run", str(run), "--platform", "cpu", "--batchsize", "4", "--frames", str(dump)]
    outs = {}
    for name, extra in (("one", []), ("two", ["--num-devices", "2"])):
        for what, flags in (("pred", []), ("roll", ["--rollout", "2", "--calibrate", str(dump)])):
            out = tmp_path / f"{name}_{what}"
            report = infer.main(base + flags + extra + ["--out", str(out)])
            assert json.loads((out / "infer_report.json").read_text())["n_frames"] == 4
            outs[name, what] = (report, out)
    for what, prefixes in (("pred", ("pred_visual", "pred_tactile")),
                           ("roll", ("rollout_visual", "rollout_tactile"))):
        (one, one_dir), (two, two_dir) = outs["one", what], outs["two", what]
        assert {k for k in two if "latency" not in k and k != "rollout_s"} == \
            {k for k in one if "latency" not in k and k != "rollout_s"}
        for prefix in prefixes:
            a, b = _pngs(one_dir, prefix), _pngs(two_dir, prefix)
            assert len(a) == len(b) > 0, prefix
            assert max(int(np.abs(x - y).max()) for x, y in zip(a, b)) <= 1, prefix
    arts = {}
    for name, extra in (("one", []), ("two", ["--num-devices", "2"])):
        manifest = infer.main(["--run", str(run), "--platform", "cpu", "--batchsize", "4",
                               "--export", str(tmp_path / f"art_{name}")] + extra)
        assert manifest["batch_size"] == 4 and manifest["platforms"] == ["cpu"]
        arts[name] = load_exported(tmp_path / f"art_{name}")
    x = {k: v[:4] for k, v in _serving_inputs().items() if k != "pose"}
    want, got = arts["one"](**x), arts["two"](**x)
    assert want.keys() == got.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_one_rank_group_trains_bit_for_bit(corpus, tmp_path):
    """``--num-devices 1`` trains in a one-rank group, every collective
    included, to the parameters of the run without a group bit for bit;
    the group is gone afterwards."""
    argv = ["--problem-type", "seq_modeling", "--model-name", "cnn-mvae",
            "--input-type", "visuotactile", "--use-pose", "--dataset-path", str(corpus),
            "--batchsize", "4", "--latent-size", "8", "--num-epochs", "1",
            "--no-tensorboard", "--platform", "cpu"]
    plain = cli_main.main(argv + ["--log-dir", str(tmp_path / "plain")])
    one = cli_main.main(argv + ["--log-dir", str(tmp_path / "one"), "--num-devices", "1"])
    assert one.mesh.size == 1 and one.mesh.collectives > 0
    assert not torch.distributed.is_initialized()
    a, b = plain.state.model.state_dict(), one.state.model.state_dict()
    for k, v in a.items():
        assert torch.equal(v, b[k]), k
    assert _losses(tmp_path / "one") == _losses(tmp_path / "plain")


def test_stop_mid_epoch_then_resume_at_two_ranks(corpus, tmp_path):
    """A stop asked on rank 1 alone after optimizer step 6 stops both ranks
    at that step (``agree``); resumed at the same world size, the run ends
    as the uninterrupted two-rank run does, bit for bit."""
    (res, _) = spawn(_stop_then_resume, 2, (str(corpus), str(tmp_path)), timeout=TIMEOUT)
    assert res["where"] == (True, 1, 2)
    assert res["resumed_val"] == res["full_val"]
    for k, v in res["full"].items():
        assert np.array_equal(res["resumed"][k], v), k


def test_multihost_smoke_tool():
    """``python -m mmdyn_tpu_torch.tools.multihost_smoke --spawn 2``: the
    golden run and two ranks agree within 1e-5."""
    report = multihost_smoke.main(["--spawn", "2", "--platform", "cpu",
                                   "--timeout", str(TIMEOUT)])
    assert report["ok"], report
    assert report["process_0_max_rel_gap"] <= 1e-5 and report["process_1_max_rel_gap"] <= 1e-5


def test_multihost_smoke_launched_by_hand():
    """Two ``multihost_smoke --coordinator 127.0.0.1:<port> --num-processes 2
    --process-id i`` processes, started as the JAX tool's parent starts its
    children, join one group through ``make_mesh``'s ``tcp://`` rendezvous;
    each rank's losses are the ``--spawn 2`` golden run's within the tool's
    1e-5."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mmdyn_tpu_torch.tools.multihost_smoke", "--platform",
         "cpu", "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(i), "--timeout", str(TIMEOUT)],
        cwd=Path(__file__).resolve().parents[1], env={**os.environ, "OMP_NUM_THREADS": "1"},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for i in range(2)]
    golden = multihost_smoke.run_training("cpu")
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=TIMEOUT)
        finally:
            p.kill()
        assert p.returncode == 0, err
        outs.append(json.loads(out.strip().splitlines()[-1]))
    assert [o["process"] for o in outs] == [0, 1]
    for o in outs:
        assert len(o["losses"]) == len(golden) == 6
        rel = max(abs(a - b) / max(abs(b), 1e-9) for a, b in zip(o["losses"], golden))
        assert rel <= 1e-5, (o, golden)
