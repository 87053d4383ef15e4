"""``correct`` must come out false for the control (the plain reference at
the next precision below the configuration's, in the program's place) and
for each fault that a cell can have, planted under the timed path while the
rest of a run goes on as it does on the chip. At a size the CPU runs; the
``card`` tests run the committed cells at their own size on the chip."""

import json
import subprocess
import sys

import pytest

from bench_port import core
from bench_port.tests.tiny import run_tiny

CELLS = [w["name"] for w in core.read_json(core.MANIFEST)["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    control = core.find_cell(name)[1]["control"]
    result, checks = run_tiny(name, control=control)
    assert result["correct"] is False, checks


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered_loss"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_training_step_is_not_correct(name, fault):
    result, checks = run_tiny(name, fault=fault)
    assert result["correct"] is False, checks


def test_a_sound_float32_run_is_correct():
    result, checks = run_tiny("dyn-f32-b256x8", seed=11)
    assert result["correct"] is True, checks


def test_without_a_card_the_benchmark_prints_no_result():
    out = subprocess.run([sys.executable, "bench_port/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=core.ROOT, timeout=300)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout.strip() == ""


def _run_on_card(name, *extra):
    out = subprocess.run([sys.executable, "bench_port/run.py", "--workload", name,
                          "--seed", "123456789012", "--seconds", "3", *extra],
                         capture_output=True, text=True, cwd=core.ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_each_cell_on_the_card(card, name):
    result = _run_on_card(name, "--trace", "0")
    assert result["correct"] is True, result["checks"]
    assert list(result)[-1] == "checks"
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert "setup_s" in result["metrics"]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_the_control_on_the_card(card, name):
    control = core.find_cell(name)[1]["control"]
    result = _run_on_card(name, "--trace", "0", "--control", control)
    assert result["correct"] is False, result["checks"]
