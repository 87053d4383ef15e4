"""Port parity: the simulator's dump CLIs (``mmdyn_tpu_torch.cli.demo`` and
``exp_{1,2,3}``) against the JAX package's on the CPU, at the argv of the JAX
package's own CLI tests (``tests/test_physics_jax.py``,
``tests/test_tactile_jax.py``, ``tests/test_pybullet_contract.py``).

* The host path (no device flag): the port's dump tree equals the JAX CLI's,
  data.json and PNG bytes alike; also through ``--workers 2``.
* ``--device-physics --platform cpu`` against the JAX CLI's
  ``--device-physics``: the same layout and time steps; shocks exact;
  positions within atol 1e-4; forces within rtol 1e-4, and during exp_3's
  shock at the JAX test's bounds (rtol 0.05, atol 1.0); the PNGs at
  ``tests/test_torch_sim.py``'s bounds (``assert_frames_close``). The same
  for ``demo --device-render``.
* PyBullet, through ``tests/fake_pybullet.py``: the port's ``demo`` and
  ``exp_{1,2,3} --engine pybullet`` make the JAX package's calls and dumps.
* Without a card and without ``--platform cpu`` the device flags raise.
"""

import importlib
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tests.fake_pybullet as fake_pybullet
from tests.test_torch_simrun import assert_frames_close
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
BOTTLE_OBJ = REPO / "graphics/objects/winebottle/models/model_normalized.obj"
BOWL_OBJ = REPO / "graphics/objects/bowl/models/model_normalized.obj"

# the argv of the JAX package's CLI tests
ARGV = {
    "exp_1_flat_plane": ["--engine", "analytic", "--headless", "--n_objects", "2",
                         "--trial_per_obj", "1", "--n_timesteps", "40", "--interval", "10",
                         "--seed", "5"],
    "exp_2_inclined_plane": ["--engine", "analytic", "--headless", "--n_objects", "1",
                             "--trial_per_obj", "2", "--n_timesteps", "60", "--interval", "10",
                             "--seed", "4", "--slope", "0.2"],
    "exp_3_force_pert": ["--engine", "analytic", "--headless", "--n_objects", "1",
                         "--trial_per_obj", "2", "--n_timesteps", "200", "--interval", "10",
                         "--snapshot_from", "100", "--seed", "9", "--force", "0.05"],
    "demo": ["--engine", "analytic", "--headless", "--n_timesteps", "60", "--interval", "10",
             "--object", "winebottle"],
}
DEMO_RENDER_ARGV = ["--headless", "--engine", "analytic", "--n_timesteps", "120",
                    "--interval", "20", "--seed", "3", "--object", "bowl"]


def _mains(cli):
    return (importlib.import_module(f"mmdyn_tpu.cli.{cli}").main,
            importlib.import_module(f"mmdyn_tpu_torch.cli.{cli}").main)


def _files(root):
    return sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file())


def _assert_trees_equal(got, want):
    assert _files(got) == _files(want) and _files(want)
    for f in _files(want):
        assert (got / f).read_bytes() == (want / f).read_bytes(), f


@pytest.mark.parametrize("cli", sorted(ARGV))
def test_host_path_dumps_equal_jax(cli, tmp_path):
    jax_main, port_main = _mains(cli)
    jax_main(ARGV[cli] + ["--logdir", str(tmp_path / "jax")])
    port_main(ARGV[cli] + ["--logdir", str(tmp_path / "port")])
    _assert_trees_equal(tmp_path / "port", tmp_path / "jax")


def test_host_path_workers_dumps_equal_jax(tmp_path):
    """``--workers 2`` (a spawn pool of trial processes) writes the JAX CLI's
    sequential dump."""
    jax_main, port_main = _mains("exp_1_flat_plane")
    argv = ARGV["exp_1_flat_plane"][:-4] + ["--n_timesteps", "20", "--seed", "5"]
    jax_main(argv + ["--logdir", str(tmp_path / "jax")])
    port_main(argv + ["--workers", "2", "--logdir", str(tmp_path / "port")])
    _assert_trees_equal(tmp_path / "port", tmp_path / "jax")


def _assert_device_dumps_close(got, want, shock_window=None):
    assert _files(got) == _files(want) and _files(want)
    seqs = sorted({f.parent for f in _files(want)})
    for seq in seqs:
        dg = json.loads((got / seq / "data.json").read_text())
        dw = json.loads((want / seq / "data.json").read_text())
        assert sorted(dg) == sorted(dw)
        assert dg["time_step"] == dw["time_step"]
        np.testing.assert_allclose(dg["position"], dw["position"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(dg["orientation"], dw["orientation"], rtol=0, atol=1e-6)
        if "shock" in dw:
            assert dg["shock"] == dw["shock"]
        if "force" in dw:
            t = np.asarray(dw["time_step"])
            shocked = np.zeros(len(t), bool) if shock_window is None else \
                (t >= shock_window[0]) & (t <= shock_window[1])
            fg, fw = np.asarray(dg["force"]), np.asarray(dw["force"])
            np.testing.assert_allclose(fg[~shocked], fw[~shocked], rtol=1e-4)
            np.testing.assert_allclose(fg[shocked], fw[shocked], rtol=0.05, atol=1.0)
        counters = range(len(dw["time_step"]))
        assert_frames_close(got / seq, want / seq, counters)


@pytest.mark.parametrize("cli", sorted(ARGV))
def test_device_physics_on_the_cpu_matches_jax(cli, tmp_path):
    from mmdyn_tpu_torch.cli.exp_3_force_pert import SHOCK_FIRST, SHOCK_LAST

    jax_main, port_main = _mains(cli)
    jax_main(ARGV[cli] + ["--device-physics", "--logdir", str(tmp_path / "jax")])
    port_main(ARGV[cli] + ["--device-physics", "--platform", "cpu",
                           "--logdir", str(tmp_path / "port")])
    _assert_device_dumps_close(tmp_path / "port", tmp_path / "jax",
                               (SHOCK_FIRST, SHOCK_LAST) if cli == "exp_3_force_pert" else None)


def test_demo_device_render_on_the_cpu_matches_jax(tmp_path):
    jax_main, port_main = _mains("demo")
    jax_main(DEMO_RENDER_ARGV + ["--device-render", "--logdir", str(tmp_path / "jax")])
    port_main(DEMO_RENDER_ARGV + ["--device-render", "--platform", "cpu",
                                  "--logdir", str(tmp_path / "port")])
    _assert_device_dumps_close(tmp_path / "port", tmp_path / "jax")


@pytest.mark.parametrize("cli, flag", [(cli, "--device-physics") for cli in sorted(ARGV)]
                         + [("exp_1_flat_plane", "--device-render"), ("demo", "--device-render")])
def test_device_flags_want_a_card(cli, flag, tmp_path, monkeypatch):
    """Without a card, a device flag raises unless ``--platform cpu`` is
    given; nothing falls back to the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port_main = _mains(cli)[1]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main(ARGV[cli] + [flag, "--logdir", str(tmp_path / "dump")])
    assert not (tmp_path / "dump").exists()


# --- PyBullet, through the fake -------------------------------------------------------


def _calls(fake):
    """The fake's call log with its temporary data path and arrays made
    comparable."""
    data_dir = str(sys.modules["pybullet_data"].getDataPath())

    def norm(v):
        if isinstance(v, np.ndarray):
            return ("array", v.shape, v.tolist())
        if isinstance(v, (list, tuple)):
            return [norm(x) for x in v]
        if isinstance(v, dict):
            return {k: norm(x) for k, x in v.items()}
        if isinstance(v, (str, Path)):
            return str(v).replace(data_dir, "<data>")
        return v

    return [(name, norm(kw)) for name, kw in fake.CALLS]


def _run_under_fake(main, argv):
    fake = fake_pybullet.install()
    try:
        main(argv)
        return _calls(fake)
    finally:
        fake_pybullet.uninstall()


@pytest.fixture
def sem_root(tmp_path):
    """tests/test_pybullet_contract.py's ShapeNetSem fixture."""
    root = tmp_path / "ShapeNetSem"
    models = root / "models-OBJ" / "models"
    models.mkdir(parents=True)
    for src, name in ((BOWL_OBJ, "fixture_bowl"), (BOTTLE_OBJ, "fixture_bottle")):
        shutil.copy(src, models / f"{name}.obj")
        shutil.copy(src.with_suffix(".mtl"), models / f"{name}.mtl")
    (root / "categories.synset.csv").write_text(
        "category,synset\nBowl,02880940\nWineBottle,04591713\nHammer,03481172\n")
    (root / "metadata.csv").write_text(
        "fullId,category,wnsynset,weight,unit,up,front\n"
        "wss.fixture_bowl,Bowl,02880940,0.35,1.0,\"0,0,1\",\"1,0,0\"\n"
        "wss.fixture_bottle,WineBottle,04591713,,,,\n"
        "wss.other_obj,Hammer,03481172,1.0,1.0,\"0,0,1\",\"1,0,0\"\n")
    return root


# the PyBullet runs' argv: test_pybullet_contract.py's demo and exp_1 runs;
# exp_2 and exp_3 on exp_1's ShapeNetSem fixture, exp_3 long enough for three
# snapshots after its first shocked step
_SEM_ARGV = ["--engine", "pybullet", "--headless", "--category", "Bowl", "--trial_per_obj",
             "1", "--interval", "10", "--fast-shading", "--seed", "3"]
PYBULLET_ARGV = {
    "demo": ["--engine", "pybullet", "--headless", "--n_timesteps", "30", "--interval", "10",
             "--fast-shading"],
    "exp_1_flat_plane": _SEM_ARGV + ["--n_timesteps", "30"],
    "exp_2_inclined_plane": _SEM_ARGV + ["--n_timesteps", "30", "--slope", "0.2"],
    "exp_3_force_pert": _SEM_ARGV + ["--n_timesteps", "140", "--snapshot_from", "110",
                                     "--force", "0.05"],
}


@pytest.mark.parametrize("cli", list(PYBULLET_ARGV))
def test_pybullet_path_under_the_fake_equals_jax(cli, sem_root, tmp_path, monkeypatch):
    """test_pybullet_contract.py's PyBullet runs of demo (the bundled
    winebottle mesh) and exp_1 (the ShapeNetSem fixture), and exp_2 (the
    constrained tilted sensor, pinned again every step) and exp_3 (the
    shocked movable sensor) on exp_1's fixture: the port makes the same
    pybullet calls and writes the same dump."""
    monkeypatch.chdir(REPO)              # graphics/ resolves from the repo root
    argv = PYBULLET_ARGV[cli]
    if cli != "demo":
        argv = argv + ["--dataset_dir", str(sem_root)]
    jax_main, port_main = _mains(cli)
    want = _run_under_fake(jax_main, argv + ["--logdir", str(tmp_path / "jax")])
    got = _run_under_fake(port_main, argv + ["--logdir", str(tmp_path / "port")])
    names = [n for n, _ in want]
    assert "getCameraImage" in names and "createCollisionShape" in names
    assert got == want
    _assert_trees_equal(tmp_path / "port", tmp_path / "jax")
    assert len(_files(tmp_path / "port")) == 13     # 3 snapshots x 4 PNGs + data.json
