"""The frozen plain reference against the port at a tiny size on the CPU,
where both compute in float32: the training step (through the harness's
own run of the loop, which compares them)."""

import pytest
import torch

from bench_port import core
from bench_port.reference.model import round_operand
from bench_port.tests.tiny import run_tiny


def test_training_step_equals_the_reference_in_float32():
    result, checks = run_tiny("dyn-f32-b256x8", seed=3)
    values = {k: c["value"] for k, c in checks.items()}
    assert result["correct"] and values["rows_bad"] == 0
    assert values["loss_gap_step1"] < 1e-5
    assert values["grad_gap"] < 1e-4


def test_seq_batches_and_targets_equal_the_reference_in_float32():
    """The seq path's inputs and targets (frame 0 against the resting
    frames) through the float32 policy, with the dyn cell's configuration
    put to seq_modeling."""
    result, checks = run_tiny("dyn-f32-b256x8", seed=4,
                              model={"problem_type": "seq_modeling"})
    values = {k: c["value"] for k, c in checks.items()}
    assert values["rows_bad"] == 0
    assert values["loss_gap_step1"] < 1e-5
    assert values["grad_gap"] < 1e-4


@pytest.mark.parametrize("precision,bits", [("tf32", 10), ("fp8", 3)])
def test_lower_precisions_round_as_stated(precision, bits):
    x = torch.randn(10000) * 3
    y = round_operand(x, precision)
    rel = ((y - x).abs() / x.abs().clamp_min(1e-3)).max()
    assert 2.0 ** -(bits + 2) < rel <= 2.0 ** -(bits + 1) * 1.01
    assert torch.equal(round_operand(y, precision), y)


def test_seed_words_take_any_whole_number():
    words = {core.seed_words(s, 0) for s in (0, 1, -1, 2**31 + 1, 2**40)}
    assert len(words) == 5 and all(0 <= w < 2**63 for w in words)
