"""Port parity: the tools of ``mmdyn_tpu_torch.tools`` (and
``mmdyn_tpu_torch.utils.training``) against the JAX package's ``tools/``.

A flax model is initialised from a seed at latent 8 and saved as a JAX run
(``mmdyn_tpu.train.checkpoint.save_checkpoint``, ``problem.pkl``,
``norms.json``); its parameters go through ``params_from_jax`` into a port
run with the same ``problem.pkl`` and ``norms.json``. The JAX tool runs on
the JAX run and the port's tool on the port run with ``--platform cpu``, on
the same seeded dumps or corpus.

Tolerance: every number of a report within atol 1e-4 after the tools' own
rounding; every boolean, count, string and key set equal; PNG strips and
re-rendered frames within 1 count. Freezing BatchNorm runs the decoders on a
sampled z, and the JAX and torch generators draw different numbers: where a
tool freezes (``--calibrate``), both sides draw the same seeded numpy noise.
"""

import contextlib
import io
import json
import pickle
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmdyn_tpu.data.dataset import VisuoTactileArrays as JaxArrays
from mmdyn_tpu.models import vae as jax_vae
from mmdyn_tpu.problems.base import ProblemConfig as JaxConfig
from mmdyn_tpu.problems.base import make_optimizer as jax_make_optimizer
from mmdyn_tpu.serve import InferenceSession as JaxSession
from mmdyn_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from mmdyn_tpu.train.state import create_train_state as jax_create_train_state
from mmdyn_tpu.utils import training as jax_training
from tools import accuracy_suite as jax_accuracy
from tools import bullet_diff as jax_bullet_diff
from tools import counterfactual as jax_counterfactual
from tools import plot_run as jax_plot_run
from tools import rerender_dataset as jax_rerender
from tools import rollout_eval as jax_rollout_eval

from mmdyn_tpu_torch.cli import demo
from mmdyn_tpu_torch.cli import main as cli_main
from mmdyn_tpu_torch.data.compile import COMPILED_NAME
from mmdyn_tpu_torch.data.synthetic import make_compiled_arrays, make_synthetic_dumps
from mmdyn_tpu_torch.models import model_kwargs, setup_model
from mmdyn_tpu_torch.models import vae
from mmdyn_tpu_torch.problems.base import ProblemConfig, make_optimizer
from mmdyn_tpu_torch.tools import (accuracy_suite, bench_http, bench_infer, bullet_diff,
                                   counterfactual, plot_run, rerender_dataset,
                                   rollout_eval)
from mmdyn_tpu_torch.train import create_train_state
from mmdyn_tpu_torch.train.checkpoint import save_checkpoint
from mmdyn_tpu_torch.utils import training
from mmdyn_tpu_torch.utils.weights import params_from_jax
from tests.torch_threads import one_torch_thread  # noqa: F401

LATENT = 8
ATOL = 1e-4
CPU = ["--platform", "cpu"]
# the norms a run's norms.json records; not the identity, so the pose and
# shock (de)normalisation is exercised
NORMS = {"pose_min": [-1.0, -2.0, 0.0, -1.0, -1.0, -1.0, -1.0],
         "pose_max": [1.0, 2.0, 1.5, 1.0, 1.0, 1.0, 1.0],
         "shock_min": [0.0], "shock_max": [2.0], "crop": True}

FAMILIES = {
    "cnn-vae-dyn": dict(problem_type="dyn_modeling", model_name="cnn-vae",
                        input_type="visual"),
    "mvae-seq": dict(problem_type="seq_modeling", model_name="cnn-mvae",
                     input_type="visuotactile", use_pose=True),
    "mvae-dyn": dict(problem_type="dyn_modeling", model_name="cnn-mvae",
                     input_type="visuotactile", use_pose=True),
    "cond-mvae": dict(problem_type="seq_modeling", model_name="cnn-mvae",
                      input_type="visuotactile", conditional=True, condition_dim=2),
    "cond-mvae-shock": dict(problem_type="seq_modeling", model_name="cnn-mvae",
                            input_type="visuotactile", use_pose=True, conditional=True,
                            condition_dim=1),
    "regressor": dict(problem_type="regression", model_name="regressor",
                      input_type="visual"),
}


def _runs(tmp_path, family, seed=0, norms=NORMS):
    """(JAX run, port run): one flax model of ``family``, initialised from
    ``seed``, saved by each package's ``save_checkpoint`` beside the same
    ``problem.pkl`` and ``norms.json``."""
    spec = FAMILIES[family]
    jcfg = JaxConfig(latent_size=LATENT, batchsize=2, **spec)
    model = JaxSession(jcfg, {}).model
    keys = jax.random.split(jax.random.PRNGKey(seed), 3)
    rngs = dict(zip(("params", "dropout", "reparam"), keys))
    img = jnp.zeros((2, 64, 64, 3))
    cond = jnp.zeros((2, jcfg.condition_dim)) if jcfg.conditional else None
    if jcfg.is_mvae:
        args = ([img, img], jnp.zeros((2, 7)) if jcfg.use_pose else None, cond)
    else:
        args = (img, cond)
    params = jax.tree_util.tree_map(np.asarray, model.init(rngs, *args)["params"])
    saved = {k: getattr(jcfg, k) for k in ("problem_type", "model_name", "input_type",
                                           "use_pose", "conditional", "latent_size",
                                           "batchsize")}
    jax_run, torch_run = tmp_path / f"jax_{family}", tmp_path / f"torch_{family}"
    for run in (jax_run, torch_run):
        (run / "checkpoint").mkdir(parents=True)
        with open(run / "problem.pkl", "wb") as f:
            pickle.dump(dict(saved, dataset_path="unused"), f)
        with open(run / "norms.json", "w") as f:
            json.dump(norms, f)
    jax_save_checkpoint(jax_run / "checkpoint",
                        jax_create_train_state(params, jax_make_optimizer(jcfg)),
                        0, 1.0, name="latest")
    tcfg = ProblemConfig(latent_size=LATENT, batchsize=2, **spec)
    net = setup_model(tcfg.model_name, cross_modal=tcfg.cross_modal, device="cpu",
                      **model_kwargs(tcfg))
    net.load_state_dict(params_from_jax(tcfg.model_name, params))
    save_checkpoint(torch_run / "checkpoint",
                    create_train_state(net, make_optimizer(tcfg, net.parameters())),
                    0, 1.0, name="latest")
    return jax_run, torch_run


@contextlib.contextmanager
def shared_noise():
    """Inside the block both packages reparameterise with the same noise,
    drawn by numpy from one seed for each shape."""
    def eps(shape):
        return np.random.default_rng(3).standard_normal(tuple(shape)).astype(np.float32)

    def jax_reparam(rng, mu, logvar):
        return jnp.asarray(eps(mu.shape)) * jnp.exp(0.5 * logvar) + mu

    def torch_reparam(generator, mu, logvar):
        return torch.as_tensor(eps(mu.shape)) * torch.exp(0.5 * logvar) + mu

    real = jax_vae.reparametrize, vae.reparametrize
    jax_vae.reparametrize, vae.reparametrize = jax_reparam, torch_reparam
    try:
        yield
    finally:
        jax_vae.reparametrize, vae.reparametrize = real


def assert_reports_close(got, want, skip=(), where="report"):
    """Same keys; numbers within ATOL; booleans, counts and strings equal."""
    if isinstance(want, dict):
        assert set(got) == set(want), (where, sorted(set(got) ^ set(want)))
        for k in want:
            if k not in skip:
                assert_reports_close(got[k], want[k], skip, f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_reports_close(g, w, skip, f"{where}[{i}]")
    elif isinstance(want, (bool, np.bool_, str, int)) and not isinstance(want, float):
        assert type(got) is type(want) and got == want, (where, got, want)
    else:
        assert isinstance(got, float) and abs(got - want) <= ATOL, (where, got, want)


def assert_pngs_close(a, b):
    from PIL import Image

    x = np.asarray(Image.open(a)).astype(np.int16)
    y = np.asarray(Image.open(b)).astype(np.int16)
    assert x.shape == y.shape and np.abs(x - y).max() <= 1, (a, np.abs(x - y).max())


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    """One simulator-shaped sequence of 5 frames, and a copy without its
    seg PNGs (no crop boxes, no masks)."""
    root = tmp_path_factory.mktemp("dump")
    make_synthetic_dumps(root / "ds", n_sequences=1, seq_length=5)
    seq = next((root / "ds").glob("**/visual_0000.png")).parent
    bare = root / "no_seg"
    shutil.copytree(seq, bare, ignore=shutil.ignore_patterns("seg_*"))
    return {True: seq, False: bare}


# --------------------------------------------------------------------------
# rollout_eval, counterfactual

@pytest.mark.parametrize("seg", [True, False], ids=["seg", "no_seg"])
@pytest.mark.parametrize("family", ["cnn-vae-dyn", "mvae-seq"])
def test_rollout_eval_matches_jax(tmp_path, dump, family, seg):
    jax_run, torch_run = _runs(tmp_path, family)
    frames = str(dump[seg])
    want = jax_rollout_eval.main(["--run", str(jax_run), "--frames", frames,
                                  "--strip", str(tmp_path / "jax.png")])
    got = rollout_eval.main(["--run", str(torch_run), "--frames", frames,
                             "--strip", str(tmp_path / "torch.png"),
                             "--out", str(tmp_path / "r.json")] + CPU)
    assert_reports_close(got, want, skip=("run", "strip"))
    assert got.get("masked") is (True if seg else None)
    assert got["horizon"] == 4 and len(got["visual"]["rollout_l1"]) == 4
    assert json.loads((tmp_path / "r.json").read_text()) == got
    assert_pngs_close(tmp_path / "torch.png", tmp_path / "jax.png")


def test_counterfactual_matches_jax(tmp_path, dump):
    jax_run, torch_run = _runs(tmp_path, "cond-mvae")
    argv = ["--frames", str(dump[True]), "--sweep", "0,0.5,1", "--calibrate",
            str(dump[True])]
    with shared_noise():
        want = jax_counterfactual.main(argv + ["--run", str(jax_run),
                                               "--strip", str(tmp_path / "jax.png")])
        got = counterfactual.main(argv + ["--run", str(torch_run),
                                          "--strip", str(tmp_path / "torch.png")] + CPU)
    assert_reports_close(got, want, skip=("run", "strip"))
    assert got["visual_l1_vs_base"][0] == 0.0 and got["condition_sensitivity"] > 0
    assert_pngs_close(tmp_path / "torch.png", tmp_path / "jax.png")


# --------------------------------------------------------------------------
# accuracy_suite

def test_accuracy_suite_matches_jax(tmp_path):
    ds = tmp_path / "corpus"
    make_compiled_arrays(ds / COMPILED_NAME, n_sequences=24, seq_length=3, with_shock=True,
                         seed=1)
    runs = {flag: _runs(tmp_path, family, seed=i) for i, (flag, family) in enumerate(
        [("reg", "regressor"), ("seq", "mvae-seq"), ("dyn", "mvae-dyn"),
         ("cond", "cond-mvae-shock")])}
    got = accuracy_suite.main(
        ["--dataset", str(ds), "--out", str(tmp_path / "acc.json")] + CPU
        + [a for flag, (_, run) in runs.items() for a in (f"--{flag}-run", str(run))])

    train = JaxArrays(str(ds), train=True).arrays
    test = JaxArrays(str(ds), train=False).arrays
    want = {"dataset": str(ds), "crop": True, "n_train": 19, "n_test": 4}
    for flag, fn in (("reg", jax_accuracy.eval_regression), ("seq", jax_accuracy.eval_seq),
                     ("dyn", jax_accuracy.eval_dyn),
                     ("cond", jax_accuracy.eval_conditional)):
        fn(str(runs[flag][0]), train, test, want)
    assert_reports_close(got, want)
    assert set(got) >= {"regression", "seq_modeling", "dyn_modeling", "conditional"}
    assert "onestep_pos_err_pose_only_m" in got["dyn_modeling"]
    assert json.loads((tmp_path / "acc.json").read_text()) == got


# --------------------------------------------------------------------------
# rerender_dataset, bullet_diff (the simulator's dumps)

def test_rerender_dataset_matches_jax(tmp_path, monkeypatch):
    import cv2

    demo.main(["--headless", "--engine", "analytic", "--object", "bowl",
               "--n_timesteps", "60", "--interval", "20", "--seed", "3",
               "--logdir", str(tmp_path)])
    monkeypatch.setattr("sys.argv", ["rerender_dataset.py", "--dataset", str(tmp_path),
                                     "--suffix", "_jax", "--thickness", "0.01"])
    jax_rerender.main()
    report = rerender_dataset.main(["--dataset", str(tmp_path), "--suffix", "_re",
                                    "--thickness", "0.01", "--batch", "2"] + CPU)
    assert report["frames"] == 3
    assert set(report) == {"frames", "seconds", "frames_per_sec", "host_read_s",
                           "render_s", "write_s"}
    out = tmp_path / "dataset"
    # the suffix is normalised to '-re': the compiler's tactile_*.png glob
    # never matches the output
    assert not list(out.glob("tactile_re_*.png"))
    for i in range(3):
        ours = cv2.imread(str(out / f"tactile-re_{i:04d}.png")).astype(int)
        theirs = cv2.imread(str(out / f"tactile-jax_{i:04d}.png")).astype(int)
        dumped = cv2.imread(str(out / f"tactile_{i:04d}.png")).astype(int)
        assert (np.abs(ours - theirs) <= 1).mean() >= 0.9999
        assert np.abs(ours - dumped).mean() < 6.0


def test_rerender_dataset_honours_the_lights(tmp_path):
    """``--i-diffuse 1.0 --i-specular 0.5`` re-renders each frame as the
    port's host sensor pipeline shades its depth PNG under those lights
    (tests/test_torch_sim.py's bounds of the renderer against the host), and
    not as the default lights do. The JAX tool keeps 2.0 and 2.0 whatever
    the flags say."""
    import cv2

    from mmdyn_tpu_torch.sim.physics import AnalyticBackend
    from mmdyn_tpu_torch.sim.sensor import make_sensor

    demo.main(["--headless", "--engine", "analytic", "--object", "bowl",
               "--n_timesteps", "60", "--interval", "20", "--seed", "3",
               "--logdir", str(tmp_path)])
    argv = ["--dataset", str(tmp_path), "--thickness", "0.01", "--batch", "2"] + CPU
    rerender_dataset.main(argv + ["--suffix=-lit", "--i-diffuse", "1.0", "--i-specular", "0.5"])
    rerender_dataset.main(argv + ["--suffix=-default"])
    # the tool's sensor: its defaults of --size and --position
    sensor = make_sensor(AnalyticBackend(), size=[1.5, 1.5, 1.0], position=[0, 0, 0.5],
                         sensor_vector=[0, 0, 1], thickness=0.01)
    rgb = sensor.get_sensor_image()[1]
    depths = sorted((tmp_path / "dataset").glob("**/depth_*.png"))
    assert len(depths) == 3

    def frame(path, stream):
        img = cv2.imread(str(path.with_name(path.name.replace("depth_", f"{stream}_"))))
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(int)

    for path in depths:
        depth = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE).astype(np.float32) / 255.0
        host = sensor.get_tactile_image(rgb, depth, sensor.get_sensor_pointcloud(rgb, depth),
                                        i_specular=0.5, i_diffuse=1.0)[:, :, :3].astype(int)
        lit, default = frame(path, "tactile-lit"), frame(path, "tactile-default")
        diff = np.abs(host - lit)
        assert (diff <= 1).mean() > 0.998
        assert (diff.max(axis=2) > 1).sum() < 2000
        assert (np.abs(lit - default).max(axis=2) > 1).mean() > 0.5


def _run_bullet_diff(main, argv):
    """(report, exit code) of a bullet_diff main; the report is the last
    line of its output (the CLIs it runs print progress)."""
    buf, code = io.StringIO(), 0
    with contextlib.redirect_stdout(buf):
        try:
            main(argv)
        except SystemExit as e:
            code = int(e.code or 0)
    return json.loads(buf.getvalue().strip().splitlines()[-1]), code


def test_bullet_diff_same_seed_is_identical(tmp_path):
    argv = ["--script", "demo", "--engines", "analytic,analytic", "--seed", "3",
            "--n_timesteps", "60", "--interval", "20"]
    got, code = _run_bullet_diff(bullet_diff.main,
                                 argv + ["--workdir", str(tmp_path / "port")] + CPU)
    want, want_code = _run_bullet_diff(jax_bullet_diff.main,
                                       argv + ["--workdir", str(tmp_path / "jax")])
    assert code == want_code == 0 and got == want and got["ok"]
    seq = got["sequences"][0]
    assert seq["pos_l2_max"] == 0.0 and seq["visual_mad_max"] == 0.0
    assert seq["tactile_mad_max"] == 0.0 and seq["seg_coverage_a"] == seq["seg_coverage_b"]


def test_bullet_diff_skip_run_report_equals_jax(tmp_path):
    common = ["--headless", "--engine", "analytic", "--n_timesteps", "60",
              "--interval", "20", "--seed", "3"]
    demo.main(common + ["--object", "winebottle", "--logdir", str(tmp_path / "a")])
    demo.main(common + ["--object", "bowl", "--logdir", str(tmp_path / "b")])
    argv = ["--skip-run", "--engines", "a,b", "--workdir", str(tmp_path),
            "--tol-pos-final", "1e-6", "--tol-img-mad", "1e-6"]
    got, code = _run_bullet_diff(bullet_diff.main, argv + CPU)
    want, want_code = _run_bullet_diff(jax_bullet_diff.main, argv)
    assert code == want_code == 1
    assert got == want and not got["ok"] and got["failures"]
    assert got["sequences"][0]["pos_l2_final"] > 0


# --------------------------------------------------------------------------
# bench_infer, bench_http (smoke at full width on the CPU)

def test_bench_infer_smoke(capsys):
    rows = bench_infer.main(["--batch-sizes", "1,2", "--iters", "2", "--warmup", "1",
                             "--rollout", "2"] + CPU)
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("{")]
    assert printed == rows and [r["metric"] for r in rows] == ["serving latency"] * 2 + [
        "rollout"]
    assert set(rows[0]) == {"metric", "batch", "p50_ms_f32", "p95_ms_f32", "p50_ms_uint8",
                            "p95_ms_uint8", "pipelined_ms", "frames_per_s"}
    assert rows[-1]["horizon"] == 2 and rows[-1]["steps_per_s"] > 0


def test_bench_http_smoke(capsys):
    rows = bench_http.main(["--clients", "2", "--requests", "2", "--batchsize", "2",
                            "--wait-ms", "50", "--calibrate-frames", "2"] + CPU)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert lines == rows and len(rows) == 2
    off, on = rows
    assert off["requests"] == on["requests"] == 4
    assert on["coalescing"] >= off["coalescing"]
    assert (off["microbatch_wait_ms"], on["microbatch_wait_ms"]) == (0.0, 50.0)


def test_bench_fresh_session_is_the_flagship():
    s = bench_infer.fresh_session(device="cpu")
    assert (s.cfg.model_name, s.cfg.input_type, s.cfg.use_pose, s.cfg.latent_size) == (
        "cnn-mvae", "visuotactile", True, 256)
    again = bench_infer.fresh_session(device="cpu")
    assert all(torch.equal(v, again.params[k]) for k, v in s.params.items())


# --------------------------------------------------------------------------
# utils/training

class _Clock:
    """time.time() stepping 1.25 s per call from 1000 s."""

    def __init__(self):
        self.t = 1000.0

    def time(self):
        self.t += 1.25
        return self.t


@pytest.mark.parametrize("seconds", [0.0, 0.0004, 0.25, 1.5, 61.123, 3599.9, 3600 * 25 + 7.5,
                                     86400 * 3])
def test_format_time_matches_jax(seconds):
    assert training.format_time(seconds) == jax_training.format_time(seconds)


def test_progress_bar_matches_jax(monkeypatch, capsys):
    outputs = []
    for mod in (jax_training, training):
        monkeypatch.setattr(mod, "time", _Clock())
        monkeypatch.setattr(mod, "_last_time", 1000.0)
        monkeypatch.setattr(mod, "_term_width", lambda: 100)
        for i in range(4):
            mod.progress_bar(i, 3, msg=f"loss {i}" if i % 2 else None)
        outputs.append(capsys.readouterr().out)
    assert outputs[0] == outputs[1] and outputs[1].endswith("\n")


def test_pickle_round_trip_across_packages(tmp_path):
    data = {"args": {"latent_size": 8}, "losses": [1.5, 2.0], "arr": np.arange(4)}
    training.save_pkl(data, tmp_path / "a.pkl")
    jax_training.save_pkl(data, tmp_path / "b.pkl")
    for got in (jax_training.load_pkl(tmp_path / "a.pkl"),
                training.load_pkl(tmp_path / "b.pkl")):
        assert got["args"] == data["args"] and got["losses"] == data["losses"]
        np.testing.assert_array_equal(got["arr"], data["arr"])


# --------------------------------------------------------------------------
# no card: every tool raises rather than run on the CPU unasked

@pytest.mark.parametrize("tool, argv", [
    (rollout_eval, ["--run", "r", "--frames", "f"]),
    (counterfactual, ["--run", "r", "--frames", "f"]),
    (accuracy_suite, ["--dataset", "d"]),
    (bench_infer, []),
    (bench_http, []),
    (rerender_dataset, ["--dataset", "d"]),
    (bullet_diff, ["--skip-run", "--workdir", "w"]),
], ids=["rollout_eval", "counterfactual", "accuracy_suite", "bench_infer", "bench_http",
        "rerender_dataset", "bullet_diff"])
def test_tools_want_a_card(tool, argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the tools take it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv)


@pytest.mark.parametrize("source", ["refcfg_exp1_record", "port_run"])
def test_plot_run_summary_is_byte_equal_to_jax(tmp_path, source):
    """``plot_run --run <run> --out <png>``: the summary JSON beside the chart
    is byte-equal to the JAX tool's on the same ``metrics.jsonl``: the JAX
    package's reference-configuration record (100 epochs, validation all 0,
    frames/s) and a 5-epoch port run through ``cli.main`` (validation
    losses); ``main`` returns the summary and the chart exists."""
    from pathlib import Path

    run = tmp_path / "run"
    if source == "port_run":
        make_compiled_arrays(tmp_path / "ds" / COMPILED_NAME, n_sequences=12,
                             seq_length=2, seed=3)
        cli_main.main(["--model-name", "cnn-vae", "--input-type", "visual",
                       "--dataset-path", str(tmp_path / "ds"), "--batchsize", "2",
                       "--num-epochs", "5", "--latent-size", "8", "--log-dir", str(run),
                       "--no-tensorboard"] + CPU)
    else:
        run.mkdir()
        repo = Path(__file__).resolve().parents[1]
        shutil.copy(repo / "docs" / "convergence" / "refcfg_exp1_metrics.jsonl",
                    run / "metrics.jsonl")
    with contextlib.redirect_stdout(io.StringIO()):
        jax_plot_run.main(["--run", str(run), "--out", str(tmp_path / "jax" / "run.png")])
        summary = plot_run.main(["--run", str(run), "--out",
                                 str(tmp_path / "port" / "run.png")])
    got, want = ((tmp_path / side / "run.json").read_bytes() for side in ("port", "jax"))
    assert got == want
    assert json.loads(got) == summary and (tmp_path / "port" / "run.png").exists()
    assert ("val_last" in summary) == (source == "port_run")
    if source == "refcfg_exp1_record":
        assert summary["train_first"] == 77985.95 and summary["epochs"] == 100
