"""No loaded module has the top-level name ``jax``, ``jaxlib``, ``flax`` or
``mmdyn_tpu``, compared whole; and the reference loads nothing of the
program."""

import subprocess
import sys
import types

import pytest

from bench_port import core


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "mmdyn_tpu_torch_probe", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping_probe", types.ModuleType("x"))
    assert "mmdyn_tpu" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "mmdyn_tpu.ops", types.ModuleType("mmdyn_tpu.ops"))
    assert core.forbidden_modules() == ["mmdyn_tpu"]


def test_finish_refuses_after_a_jax_module(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(SystemExit) as stop:
        core.finish({"correct": True}, {})
    assert stop.value.code != 0
    out, err = capsys.readouterr()
    assert out == "" and "jax" in err


def _loaded_after(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(sorted("
                          "{m.split('.')[0] for m in sys.modules}))"],
                         capture_output=True, text=True, cwd=core.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return eval(out.stdout.strip().splitlines()[-1])


def test_runs_load_no_jax():
    """A run of each cell of the harness, through to its result line, at a
    size the CPU holds."""
    loaded = _loaded_after(
        "from bench_port.tests.tiny import run_tiny\n"
        "from bench_port import core\n"
        "for w in core.read_json(core.MANIFEST)['workloads']:\n"
        "    result, checks = run_tiny(w['name'])\n"
        "    core.finish(result, checks)\n")
    assert "mmdyn_tpu_torch" in loaded
    assert not set(loaded) & set(core.FORBIDDEN_MODULES)


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded_after(
        "import bench_port.reference.model, bench_port.counts.model, bench_port.checks\n"
        "import bench_port.counts.peaks, bench_port.devtrace\n")
    assert "mmdyn_tpu_torch" not in loaded
    assert not set(loaded) & set(core.FORBIDDEN_MODULES)
