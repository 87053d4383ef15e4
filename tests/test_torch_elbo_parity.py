"""Port parity: the training-trajectory harness
``mmdyn_tpu_torch.tools.elbo_parity`` (and its golden model
``mmdyn_tpu_torch.tools.gold``) against the JAX package's
``tools/elbo_parity.py``, on the CPU.

Inputs: the harness's own seeded numpy sequences (``make_synthetic_sequences``,
``default_rng(0)``), 16 sequences x 4 frames, batch 8, latent 16. The JAX
side runs as its tool runs it: ``run_jax`` through the JAX package's
production parse / evaluate path, and ``run_torch`` on
``tests/torch_reference.py``'s golden models. The JAX initial parameters go
into the port through ``params_from_jax`` (and into both golden models).

Tolerances, per epoch's mean loss (measured with the torch side on one
thread, as the tests run it):
* the port's production step against ``run_jax``, noise-free, no dropout, 3
  epochs: rel 1e-4, or the JAX run's own distance to the reference
  semantics (its ``run_torch``) plus 1e-5 where that is larger. Measured:
  seq 8.4e-6, dyn 3.1e-5, regression 3.9e-5; the conditional MVAE 1.002e-4
  at epoch 2, where ``run_jax`` is 1.5e-4 from ``run_torch``. Each side's
  first step is within 1e-6 of the other's: the gap is float32 rounding
  grown by 6 Adam steps, about 3x a step in the conditional case;
* the port against ``run_torch``: rel 1e-4 (seq 1.6e-6, dyn 6.3e-6,
  regression 3.5e-6, conditional 5.0e-5; on eight torch threads the
  conditional reads 2.5e-7: its rounding depends on the reductions' split);
* the port's ``gold.py`` against ``tests/torch_reference.py``: bit for bit;
* ``bfloat16_full`` against ``run_jax`` at the same policy: rel 2e-3
  (``test_torch_bf16.py``'s loss bound; measured 5.3e-4);
* the port against its golden model in float64, controlled: rel 1e-12
  (``controlled_gaps``; at ``chip_smoke.py`` (m1)'s 64 x 4, batch 8, latent
  64, 30 epochs it reads 1.5e-14, where float32 reads 2.7e-3).
"""

import contextlib
import json
import types

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (conftest pins it to the CPU)

from tools import elbo_parity as jax_tool

from mmdyn_tpu_torch.data import loader
from mmdyn_tpu_torch.problems import reconstruction
from mmdyn_tpu_torch.train import steps
from mmdyn_tpu_torch.data.compile import COMPILED_NAME
from mmdyn_tpu_torch.data.synthetic import make_compiled_arrays
from mmdyn_tpu_torch.tools import elbo_parity, gold
from mmdyn_tpu_torch.train.profiler import StepTimer
from mmdyn_tpu_torch.utils.weights import params_from_jax

CPU = torch.device("cpu")
SMALL = ["--n-seq", "16", "--batch", "8", "--latent", "16"]
CONTROLLED = ["--noise-free", "--no-dropout"]
CASES = {
    "seq": ["--problem", "seq_modeling"],
    "dyn": ["--problem", "dyn_modeling"],
    "regression": ["--problem", "regression"],
    "conditional": ["--problem", "seq_modeling", "--conditional"],
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The torch side of these runs on one thread: its batches are small,
    and the suite's other workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b):
    return [abs(x - y) / abs(y) for x, y in zip(a, b)]


def _setup(argv):
    args = elbo_parity.parse_args(SMALL + CONTROLLED + argv)
    seqs = elbo_parity.make_synthetic_sequences(
        args.n_seq, args.seq_len, shock_dim=args.shock_dim if args.conditional else 0)
    return args, seqs


_JAX_RUNS = {}


def _jax_run(case, epochs=3, dtype="float32"):
    """The JAX tool's ``run_jax`` and ``run_torch`` from one JAX init, made
    once per case: (args, seqs, jax history, reference history, the port's
    ``state_dict`` of the JAX init)."""
    key = (case, epochs, dtype)
    if key not in _JAX_RUNS:
        args, seqs = _setup(CASES[case] + ["--epochs", str(epochs), "--dtype", dtype])
        init = []
        jx = jax_tool.run_jax(seqs, args, seed=0, init_params_out=init)
        ref = jax_tool.run_torch(seqs, args, seed=0, init_params=init[0])
        name = "regressor" if args.problem == "regression" else "cnn-mvae"
        _JAX_RUNS[key] = (args, seqs, jx, ref, params_from_jax(name, init[0]))
    return _JAX_RUNS[key]


def _port_run(args, seqs, state_dict):
    model = elbo_parity.port_model(args, elbo_parity.condition_dim(seqs, args), CPU)
    model.load_state_dict(state_dict)
    return elbo_parity.run_port(seqs, args, model, CPU)


@pytest.mark.parametrize("case", list(CASES))
def test_port_trajectory_matches_run_jax(case):
    args, seqs, jx, ref, sd = _jax_run(case)
    px = _port_run(args, seqs, sd)
    assert len(px) == 3 and all(np.isfinite(px))
    to_ref = _rel(px, ref)
    assert max(to_ref) <= 1e-4, (to_ref, px, ref)
    bound = [max(1e-4, r + 1e-5) for r in _rel(jx, ref)]
    to_jax = _rel(px, jx)
    assert all(g <= b for g, b in zip(to_jax, bound)), (to_jax, bound, px, jx)


@pytest.mark.parametrize("case", list(CASES))
def test_gold_copy_equals_the_reference_golden_models(case):
    """The port's ``gold.py`` (loaded from the port's ``state_dict``) trains
    bit for bit as ``tests/torch_reference.py``'s models (loaded from the
    flax tree) under the JAX tool's ``run_torch``."""
    args, seqs, _, ref, sd = _jax_run(case)
    model = elbo_parity.gold_model(args, elbo_parity.condition_dim(seqs, args), CPU)
    model.load_state_dict(sd)
    assert elbo_parity.run_torch(seqs, args, model, CPU) == ref


def test_gold_load_refuses_a_key_that_does_not_map():
    args, seqs = _setup(CASES["seq"])
    model = elbo_parity.port_model(args, 0, CPU)
    sd = model.state_dict()
    golden = elbo_parity.gold_model(args, 0, CPU)
    golden.load_state_dict(sd)
    for k in ("visual_encoder.fc_net.0.weight", "pose_decoder.deconv_net.4.bias"):
        assert torch.equal(golden.state_dict()[k], sd[k])
    sd["visual_encoder.extra.weight"] = torch.zeros(1)
    with pytest.raises(RuntimeError, match="visual_encoder.extra.weight"):
        golden.load_state_dict(sd)
    del sd["visual_encoder.extra.weight"], sd["tactile_decoder.upsample.0.bias"]
    with pytest.raises(RuntimeError, match="tactile_decoder.upsample.0.bias"):
        golden.load_state_dict(sd)


def test_bfloat16_full_matches_run_jax_at_the_same_policy():
    args, seqs, jx, _, sd = _jax_run("seq", epochs=2, dtype="bfloat16_full")
    px = _port_run(args, seqs, sd)
    gaps = _rel(px, jx)
    assert max(gaps) <= 2e-3, (gaps, px, jx)


def test_main_reports_the_jax_tools_keys(tmp_path, capsys):
    report = elbo_parity.main(["--platform", "cpu"] + SMALL + CONTROLLED
                              + ["--epochs", "2", "--shared-init"])
    assert set(report) == {"problem", "final_gap_pct", "port_elbo", "torch_elbo"}
    assert report["problem"] == "seq_modeling" and len(report["port_elbo"]) == 2
    # shared init, no randomness: the fused step is the sequential passes'
    assert max(_rel(report["port_elbo"], report["torch_elbo"])) <= 1e-4
    assert 0.0 <= report["final_gap_pct"] <= 1e-2     # percent: rel 1e-4
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == report
    assert "# port epoch 1:" in err and "# torch done in" in err

    path = tmp_path / "seeds.json"
    report = elbo_parity.main(["--platform", "cpu", "--problem", "regression",
                               "--seeds", "0,1", "--skip-torch", "--out", str(path)]
                              + SMALL + ["--epochs", "2"])
    assert set(report) == {"problem", "port_elbo_by_seed", "port_final_min",
                           "port_final_max"}
    assert set(report["port_elbo_by_seed"]) == {"0", "1"}
    finals = [h[-1] for h in report["port_elbo_by_seed"].values()]
    assert (report["port_final_min"], report["port_final_max"]) == (min(finals), max(finals))
    assert report["port_elbo_by_seed"]["0"] != report["port_elbo_by_seed"]["1"]
    assert json.loads(path.read_text()) == report


@pytest.mark.parametrize("packed_dir", [False, True])
def test_dataset_reads_as_the_jax_tool_reads_it(tmp_path, packed_dir):
    target = tmp_path / "ds" / (COMPILED_NAME if not packed_dir else "packed")
    make_compiled_arrays(target, n_sequences=10, seq_length=3, with_shock=True,
                         packed_dir=packed_dir)
    where = tmp_path / "ds" if not packed_dir else target
    want = jax_tool.load_compiled_sequences(where, 9)
    got = elbo_parity.load_compiled_sequences(where, 9)
    assert got.keys() == want.keys() and "shock" in got
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    report = elbo_parity.main(["--platform", "cpu", "--dataset", str(where),
                               "--conditional", "--n-seq", "9", "--batch", "4",
                               "--latent", "8", "--epochs", "1", "--skip-torch"])
    assert set(report) == {"problem", "port_elbo"} and np.isfinite(report["port_elbo"][0])


def test_synthetic_sequences_and_dyn_targets_are_the_jax_tools():
    for shock in (0, 3):
        want = jax_tool.make_synthetic_sequences(5, 3, shock_dim=shock)
        got = elbo_parity.make_synthetic_sequences(5, 3, shock_dim=shock)
        assert got.keys() == want.keys()
        assert all(np.array_equal(got[k], want[k]) for k in want)
    x = np.arange(2 * 3 * 2, dtype=np.float32).reshape(2, 3, 2)
    final = -np.ones((2, 2), np.float32)
    for a, b in zip(elbo_parity.dyn_flatten_roll(x, final),
                    jax_tool.dyn_flatten_roll(x, final)):
        assert np.array_equal(a, b)


def test_conditional_needs_a_shock_stream(tmp_path):
    make_compiled_arrays(tmp_path / COMPILED_NAME, n_sequences=4, seq_length=2)
    with pytest.raises(SystemExit, match="shock stream"):
        elbo_parity.main(["--platform", "cpu", "--dataset", str(tmp_path),
                          "--conditional", "--batch", "2"])


def test_entry_points_without_a_device_want_the_card(monkeypatch):
    """``to_device_batch``, ``device_prefetch``, ``StepTimer`` and
    ``gold.make_gold`` take the card when no device is named, and raise
    ``resolve_device``'s error without one; the tool does too without
    ``--platform cpu``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    batch = {"pose": np.zeros((2, 7), np.float32)}
    for call in (lambda: loader.to_device_batch(batch),
                 lambda: loader.device_prefetch(iter([batch])),
                 lambda: StepTimer(),
                 lambda: gold.make_gold(False, 16),
                 lambda: elbo_parity.main(SMALL + ["--epochs", "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert loader.to_device_batch(batch, "cpu")["pose"].device == CPU
    assert not StepTimer("cpu").cuda
    assert isinstance(loader.device_prefetch(iter([]), "cpu"), types.GeneratorType)
    assert next(gold.make_gold(True, 16, device="cpu").parameters()).device == CPU


@contextlib.contextmanager
def _float64():
    """Inside the block the port and the golden model compute in float64:
    new tensors and modules default to it, ``Tensor.float()`` keeps a float64
    tensor, the MVAE's subset mask is float64 and the train step moves its
    batch as float64."""
    dtype, to_float = torch.get_default_dtype(), torch.Tensor.float
    tables, to_device = reconstruction._tables, steps._to_device
    torch.set_default_dtype(torch.float64)
    torch.Tensor.float = lambda t, *a, **k: t if t.dtype == torch.float64 else to_float(t, *a, **k)
    reconstruction._tables = lambda use_pose, device: (
        (tables(use_pose, device)[0].double(),) + tables(use_pose, device)[1:])
    steps._to_device = lambda batch, device: {
        k: None if v is None else torch.as_tensor(v, dtype=torch.float64, device=device)
        for k, v in batch.items()}
    try:
        yield
    finally:
        torch.set_default_dtype(dtype)
        torch.Tensor.float = to_float
        reconstruction._tables, steps._to_device = tables, to_device


def controlled_gaps(n_seq=16, batch=8, latent=16, epochs=3, float64=True):
    """Per-epoch relative gaps between the port and its golden model from one
    init, noise-free and without dropout, in float64 (or float32). At (m1)'s
    sizes, from the repository root:
    ``python -c "from tests.test_torch_elbo_parity import controlled_gaps as g; print(g(64, 8, 64, 30))"``
    """
    args = elbo_parity.parse_args(CONTROLLED + ["--n-seq", str(n_seq), "--batch", str(batch),
                                                "--latent", str(latent), "--epochs", str(epochs)])
    seqs = elbo_parity.make_synthetic_sequences(n_seq, args.seq_len)
    with _float64() if float64 else contextlib.nullcontext():
        if float64:
            seqs = {k: v.astype(np.float64) for k, v in seqs.items()}
        model = elbo_parity.port_model(args, 0, CPU)
        golden = elbo_parity.gold_model(args, 0, CPU)
        golden.load_state_dict(model.state_dict())
        return _rel(elbo_parity.run_port(seqs, args, model, CPU),
                    elbo_parity.run_torch(seqs, args, golden, CPU))


def test_port_is_the_reference_semantics_in_float64():
    """Without float32's rounding the fused step and the 7 sequential passes
    train alike: what float32 runs show between them over long runs is
    rounding grown by the training map."""
    gaps = controlled_gaps()
    assert max(gaps) <= 1e-12, gaps
    assert torch.get_default_dtype() == torch.float32
