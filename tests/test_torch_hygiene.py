"""The port stands alone: ``mmdyn_tpu_torch``, ``chip_smoke.py`` and the
kernel bench ``tools/bce_bf16_bench.py`` import neither JAX, nor the JAX
package, nor the repository's ``tools`` package (the JAX package's tools),
nor its ``tests``."""

import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "mmdyn_tpu_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import mmdyn_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mmdyn_tpu_torch.__path__,
                                               "mmdyn_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "mmdyn_tpu", "tools",
                                         "tests"))
print(len(names), bad)
assert not bad, bad
"""


def test_importing_every_port_module_loads_no_jax():
    # a fresh interpreter: this test process has jax loaded by conftest
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 20, out.stdout


_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|tools|tests)\b"
                        r"|\bmmdyn_tpu\.", re.MULTILINE)


def test_no_source_names_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                          REPO / "tools" / "bce_bf16_bench.py"]
    assert len(files) > 20
    for path in files:
        hits = _FORBIDDEN.findall(path.read_text())
        assert not hits, f"{path.relative_to(REPO)}: {hits}"


_CLI_HELP = """
import runpy, sys
sys.argv = ["mmdyn_tpu_torch.{module}", "--help"]
try:
    runpy.run_module("mmdyn_tpu_torch.{module}", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "mmdyn_tpu", "tools",
                                         "tests"))
print("LOADED", bad)
assert not bad, bad
"""


@pytest.mark.parametrize("cli, flags", [
    ("main", ("--dataset-path", "--bf16-full")),
    ("infer", ("--torch-ckpt", "--rollout", "--export", "--calibrate", "--no-pose")),
    ("serve", ("--microbatch-wait-ms", "--calibrate", "--port")),
    ("demo", ("--device-physics", "--device-render", "--object")),
    ("exp_1_flat_plane", ("--device-physics", "--device-render", "--workers")),
    ("exp_2_inclined_plane", ("--device-physics", "--device-render", "--slope")),
    ("exp_3_force_pert", ("--device-physics", "--device-render", "--snapshot_from")),
    ("tools.rollout_eval", ("--frames", "--max-steps")),
    ("tools.counterfactual", ("--sweep", "--calibrate")),
    ("tools.accuracy_suite", ("--cond-run", "--no-crop")),
    ("tools.bench_infer", ("--batch-sizes", "--rollout")),
    ("tools.bench_http", ("--wait-ms", "--calibrate-frames")),
    ("tools.rerender_dataset", ("--suffix", "--thickness")),
    ("tools.bullet_diff", ("--engines", "--skip-run")),
    ("tools.multihost_smoke", ("--spawn", "--timeout", "--coordinator", "--num-processes",
                               "--process-id")),
    ("tools.elbo_parity", ("--shared-init", "--seeds")),
    ("tools.plot_run", ("--run", "--out", "--title")),
])
def test_cli_help_loads_no_jax(cli, flags):
    """``python -m mmdyn_tpu_torch.cli.<cli> --help`` (and
    ``mmdyn_tpu_torch.tools.<tool>``) in a fresh interpreter prints the
    entry point's flags and loads neither JAX, nor the JAX package, nor the
    JAX package's ``tools``, nor the repository's ``tests``. Every entry
    point that runs on a device takes ``--platform``; ``plot_run`` reads a
    run's metrics on the host and has none."""
    module = cli if cli.startswith("tools.") else f"cli.{cli}"
    if cli != "tools.plot_run":
        flags += ("--platform",)
    out = subprocess.run([sys.executable, "-c", _CLI_HELP.format(module=module)], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert all(f in out.stdout for f in flags), out.stdout
    assert "LOADED []" in out.stdout
