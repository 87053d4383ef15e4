"""The port's data parallelism (``mmdyn_tpu_torch/parallel``) on the CPU
against the port's own one process on the global batch: the train step with
noise and dropout on (also in float64), per-subset BatchNorm across ranks,
and the mesh's shape. The shared helpers and the rank functions are in
``tests/torch_parallel.py``.
"""

import math

import numpy as np
import pytest
import torch

from mmdyn_tpu_torch.parallel import make_mesh, spawn
from tests.torch_parallel import (PORT_CASES, TIMEOUT, _bn, _bn_case, _bn_ranks, _cfg,
                                  _float64_ranks, _port_ranks, _rel, _shape_ranks, _train)
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("case", list(PORT_CASES))
def test_ranks_match_one_process(case):
    """Two ranks against one process on the global batch, with noise and
    dropout drawn (every draw at the global shape, each rank keeping its
    rows; under ``augment`` its draws too) and BatchNorm statistics over
    both ranks' rows, also with ``remat`` (the forward rerun in the
    backward, its collectives with it): each step's loss
    and each first-step gradient (max gap over the tensor's max) within the
    case's bound. The parameters after three Adam steps are held in relative
    L2 norm: Adam divides each gradient element by its own magnitude plus
    1e-8, so the elements whose gradient is at float32's rounding floor
    (sums that cancel) move by up to the learning rate whatever their sign,
    and the largest single gap is 2e-3 of the largest parameter (measured
    on this case); the L2 gap is 3e-5 to 5e-5 in float32."""
    fields, bound, param_bound = PORT_CASES[case]
    ranks = spawn(_port_ranks, 2, (case,), timeout=TIMEOUT)
    want = _train(_cfg(**fields))
    for rank, got in enumerate(ranks):
        assert got["losses"] == pytest.approx(want["losses"], rel=bound), rank
        for name, g in want["grads"].items():
            assert _rel(got["grads"][name], g) <= bound, (rank, name)
        num = sum(float(np.sum((got["params"][k] - v).astype(np.float64) ** 2))
                  for k, v in want["params"].items())
        den = sum(float(np.sum(v.astype(np.float64) ** 2)) for v in want["params"].values())
        assert math.sqrt(num / den) <= param_bound, rank
    # both ranks hold one set of parameters
    for k, v in ranks[0]["params"].items():
        assert np.array_equal(v, ranks[1]["params"][k]), k


def test_ranks_match_one_process_in_float64():
    """The first step of two ranks in float64, noise and dropout drawn, sums
    to one process's on the global batch within 1e-10 (relative, set from
    float64's 2.2e-16 and the sums' lengths): the collectives (BatchNorm's
    ``var_mean``, the global draws, ``all_reduce_grads``) compute the
    one-process step exactly, and every float32 gap is rounding. On the
    card that rounding flips the pose MLPs' ReLU kinks; ``chip_smoke.py``
    (l7) measures it against a float64 step."""
    for res in spawn(_float64_ranks, 2, timeout=TIMEOUT):
        (got_loss, got), (want_loss, want) = res["ranks"], res["one"]
        assert got_loss == pytest.approx(want_loss, rel=1e-10)
        for name, g in want.items():
            assert got[name].dtype == np.float64, name
            assert _rel(got[name], g) <= 1e-10, (name, _rel(got[name], g))


def test_train_batch_norm_across_ranks():
    """Per-subset train-mode BatchNorm (groups 7) over two ranks' rows equals
    the one-process BatchNorm of the global tensor: the output, and the
    gradients of x, weight and bias through both statistics' all-reduces
    (rel 1e-5)."""
    want = _bn(*_bn_case())
    for rank, got in enumerate(spawn(_bn_ranks, 2, timeout=TIMEOUT)):
        lo = rank * 2
        assert _rel(got["y"], want["y"][:, lo:lo + 2]) <= 1e-5
        assert _rel(got["dx"], want["dx"][:, lo:lo + 2]) <= 1e-5
        assert _rel(got["dw"], want["dw"]) <= 1e-5
        assert _rel(got["db"], want["db"]) <= 1e-5


def test_mesh_shape_is_a_flat_group():
    """``make_mesh(mesh_shape=(2, 2))`` is the flat group of 4 ranks in
    row-major order: the same steps, bit for bit."""
    for res in spawn(_shape_ranks, 4, timeout=TIMEOUT):
        assert (res["shape"], res["size"]) == ((2, 2), 4)
        assert res["square"]["losses"] == res["flat"]["losses"]
        for k, v in res["flat"]["params"].items():
            assert np.array_equal(res["square"]["params"][k], v), k


def test_make_mesh_needs_its_processes():
    """A mesh of 2 in a process that is not one of 2 raises, naming the
    ways to launch them; nothing is initialised."""
    with pytest.raises(ValueError, match="needs 2 processes"):
        make_mesh(2, devices=["cpu"] * 2)
    assert not torch.distributed.is_initialized()
