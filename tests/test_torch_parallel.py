"""The port's data parallelism (``mmdyn_tpu_torch/parallel``) on the CPU:
N gloo processes against the JAX package's ``make_mesh(n)`` step and
session (over conftest's 8 host devices), and against the port's own one
process on the global batch.

Each test starts its own group of ranks by ``parallel.spawn`` around a
file rendezvous in a temporary directory, with a 120 s limit on the run and
on every collective, so a hang fails instead of eating the suite's time;
each group does one test's work, so it stays well inside the limit while
the suite's other workers load the host. The rank functions are
module-level (the spawned processes import this module) and import no JAX:
only the parent's test functions do.
"""

import contextlib
import dataclasses
import http.client
import io
import json
import math
import threading
import time

import numpy as np
import pytest
import torch

from mmdyn_tpu_torch.cli import infer
from mmdyn_tpu_torch.cli import main as cli_main
from mmdyn_tpu_torch.data.compile import COMPILED_NAME
from mmdyn_tpu_torch.data.synthetic import make_compiled_arrays
from mmdyn_tpu_torch.models import model_kwargs, setup_model
from mmdyn_tpu_torch.models.layers import bn_stats, train_batch_norm
from mmdyn_tpu_torch.parallel import (all_reduce_grads, make_mesh, reduce_metrics,
                                      shard_batch, sharded, spawn)
from mmdyn_tpu_torch.problems import ProblemConfig, make_optimizer
from mmdyn_tpu_torch.serve import InferenceSession, export_session, load_exported
from mmdyn_tpu_torch.serve.server import follow, make_server
from mmdyn_tpu_torch.tools import multihost_smoke
from mmdyn_tpu_torch.train import create_train_state, make_train_step
from mmdyn_tpu_torch.train.loop import Problem

TIMEOUT = 120
LATENT, B, T = 16, 4, 2
SERVE_ROWS = 8
# port N ranks against one process, noise and dropout on: (the config's
# fields, bound on the losses and first-step gradients, bound on the
# parameters)
PORT_CASES = {
    "seq": ({}, 1e-5, 1e-4),
    "dyn": (dict(problem_type="dyn_modeling"), 1e-5, 1e-4),
    "bf16_full": (dict(compute_dtype="bfloat16_full"), 2e-2, 2e-2),
    "remat": (dict(remat=True), 1e-5, 1e-4),
    "augment": (dict(use_pose=False, augment=True), 1e-5, 1e-4),
}


def _batch(seed=0, b=B):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.uniform(size=s).astype(np.float32)  # noqa: E731
    return {
        "visual": f(b, T, 64, 64, 3), "tactile": f(b, T, 64, 64, 3),
        "pose": f(b, T, 7), "avail": np.ones((b, T, 2), np.float32),
        "final_visual": f(b, 64, 64, 3), "final_tactile": f(b, 64, 64, 3),
        "final_pose": f(b, 7), "seg": np.ones((b, T, 64, 64, 3), np.float32),
    }


def _cfg(**fields):
    return ProblemConfig(**{**dict(problem_type="seq_modeling", model_name="cnn-mvae",
                                   input_type="visuotactile", use_pose=True,
                                   latent_size=LATENT, batchsize=B), **fields})


def _train(cfg, mesh=None, state_dict=None, steps=3, **model_overrides):
    """``steps`` Adam steps on ``_batch()`` (this rank's rows under
    ``mesh``): the losses, the first step's gradients and the parameters."""
    model = setup_model(cfg.model_name, cross_modal=True, device="cpu", seed=0,
                        **model_kwargs(cfg), **model_overrides)
    if state_dict is not None:
        model.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()})
    state = create_train_state(model, make_optimizer(cfg, model.parameters()))
    step = make_train_step(cfg, device="cpu", mesh=mesh)
    batch = _batch() if mesh is None else shard_batch(mesh, _batch())
    gen = torch.Generator().manual_seed(3)
    losses, grads = [], None
    for _ in range(steps):
        state, metrics = step(state, batch, gen, 1.0)
        losses.append(float(metrics["loss"]))
        if grads is None:
            grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}
    params = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    return {"losses": losses, "grads": grads, "params": params}


def _serving_inputs(seed=5, rows=SERVE_ROWS):
    rng = np.random.default_rng(seed)
    return {"visual": rng.uniform(size=(rows, 64, 64, 3)).astype(np.float32),
            "tactile": rng.uniform(size=(rows, 64, 64, 3)).astype(np.float32),
            "pose": rng.uniform(size=(rows, 7)).astype(np.float32)}


def _serve(state_dict, mesh=None):
    """predict, then freeze_bn and predict, of a session from ``state_dict``."""
    cfg = _cfg()
    session = InferenceSession(cfg, {k: torch.as_tensor(v) for k, v in state_dict.items()},
                               device="cpu", mesh=mesh)
    x = _serving_inputs()
    out = {k: v.numpy() for k, v in session.predict(**x).items()}
    frozen = session.freeze_bn(**x)
    out_frozen = {k: v.numpy() for k, v in frozen.predict(**x).items()}
    stats = {name: {k: v.numpy() for k, v in s.items()} for name, s in bn_stats(frozen.model).items()}
    return {"predict": out, "frozen": out_frozen, "stats": stats}


def _bn_case():
    """A (groups 7, rows 4, C 8, 5 x 5) input, affine parameters and the
    cotangent, the same in every process."""
    rng = np.random.default_rng(9)
    x = rng.normal(1.0, 2.0, size=(7, 4, 8, 5, 5)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, size=8).astype(np.float32)
    b = rng.normal(size=8).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    return x, w, b, cot


def _bn(x, w, b, cot, mesh=None):
    """train_batch_norm of the (7, n) groups of ``x`` and the gradients of
    sum(y * cot) with respect to x, w and b (w and b summed over ranks)."""
    x, cot = torch.tensor(x, requires_grad=True), torch.tensor(cot)
    w, b = torch.tensor(w, requires_grad=True), torch.tensor(b, requires_grad=True)
    with sharded(mesh):
        y = train_batch_norm(x.reshape(-1, *x.shape[2:]), w, b, groups=7)
    (y.reshape(x.shape) * cot).sum().backward()
    if mesh is not None:
        all_reduce_grads(mesh, [w, b])
    return {"y": y.detach().reshape(x.shape).numpy(), "dx": x.grad.numpy(),
            "dw": w.grad.numpy(), "db": b.grad.numpy()}


# ----------------------------------------------------------------------
# rank functions (run in the spawned processes)

def _mesh(n, **kw):
    return make_mesh(n, devices=["cpu"] * n, timeout=TIMEOUT, **kw)


def _jax_weights_ranks(n, jax_state_dict):
    """The noise-free, dropout-free run from the JAX weights on n ranks."""
    return _train(_cfg(noise_free=True), _mesh(n), jax_state_dict, dropout_rate=0.0)


def _port_ranks(case):
    return _train(_cfg(**PORT_CASES[case][0]), _mesh(2))


@contextlib.contextmanager
def _float64():
    """Inside the block the port computes in float64: new tensors and
    modules default to it, ``Tensor.float()`` keeps a float64 tensor (the
    float32 policy's casts at the layer boundaries, the BatchNorm statistics,
    the losses) and the MVAE's subset mask is float64."""
    from mmdyn_tpu_torch.problems import reconstruction

    dtype, to_float, tables = torch.get_default_dtype(), torch.Tensor.float, reconstruction._tables
    torch.set_default_dtype(torch.float64)
    torch.Tensor.float = lambda t, *a, **k: t if t.dtype == torch.float64 else to_float(t, *a, **k)
    reconstruction._tables = lambda use_pose, device: (
        (tables(use_pose, device)[0].double(),) + tables(use_pose, device)[1:])
    try:
        yield
    finally:
        torch.set_default_dtype(dtype)
        torch.Tensor.float = to_float
        reconstruction._tables = tables


def _first_grads(cfg, mesh=None):
    """The first step's loss and gradients of ``_train``'s run in float64
    (noise and dropout drawn, this rank's rows under ``mesh``)."""
    from mmdyn_tpu_torch.train.steps import _loss_and_backward

    with _float64():
        model = setup_model(cfg.model_name, cross_modal=True, device="cpu", seed=0,
                            **model_kwargs(cfg))
        batch = {k: torch.as_tensor(v, dtype=torch.float64) for k, v in _batch().items()}
        loss, _ = _loss_and_backward(model, cfg, batch if mesh is None else
                                     shard_batch(mesh, batch), torch.Generator().manual_seed(3),
                                     1.0, mesh)
        if mesh is not None:
            loss = reduce_metrics(mesh, {"loss": loss})["loss"]
            all_reduce_grads(mesh, model.parameters())
        grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}
        return float(loss.detach()), grads


def _float64_ranks():
    """Two ranks' float64 first step, and one process's on the global
    batch, computed in the rank."""
    return {"ranks": _first_grads(_cfg(), _mesh(2)), "one": _first_grads(_cfg())}


def _bn_ranks():
    mesh = _mesh(2)
    x, w, b, cot = _bn_case()
    lo = mesh.rank * 2
    return _bn(x[:, lo:lo + 2], w, b, cot[:, lo:lo + 2], mesh)


def _serve_ranks(jax_state_dict):
    return _serve(jax_state_dict, _mesh(2))


def _shape_ranks():
    flat, square = _mesh(4), make_mesh(devices=["cpu"] * 4, mesh_shape=(2, 2),
                                       timeout=TIMEOUT)
    return {"flat": _train(_cfg(), flat, steps=2), "square": _train(_cfg(), square, steps=2),
            "shape": square.shape, "size": square.size}


# serving across ranks: latent 8, the 16-row batch of tests/test_serve.py's
# aot_predict under a mesh, an artifact at batch 8, a server at batch 4
SERVE_LATENT, AOT_ROWS, EXPORT_ROWS, SERVER_BATCH = 8, 16, 8, 4


def _serve_session(state_dict, mesh=None):
    cfg = _cfg(latent_size=SERVE_LATENT)
    return InferenceSession(cfg, {k: torch.as_tensor(v) for k, v in state_dict.items()},
                            device="cpu", mesh=mesh)


def _export_both(session, root):
    """The session's artifacts at ``EXPORT_ROWS``, with batch statistics and
    frozen on ``_serving_inputs(7)``: their manifests."""
    frozen = session.freeze_bn(**_serving_inputs(7))
    return [export_session(s, f"{root}/{name}", batch_size=EXPORT_ROWS)
            for name, s in (("batch_bn", session), ("frozen_bn", frozen))]


def _aot_export_ranks(state_dict, root):
    """The two-rank session's ``aot_predict(16)`` outputs, and its
    artifacts written under ``root`` (rank 0 writes, both return the
    manifests)."""
    session = _serve_session(state_dict, _mesh(2))
    x = _serving_inputs(rows=AOT_ROWS)
    fn = session.aot_predict(AOT_ROWS, ("visual", "tactile"))
    out = {k: v.numpy() for k, v in fn({"visual": x["visual"], "tactile": x["tactile"]}).items()}
    return {"aot": out, "manifests": _export_both(session, f"{root}/rank{session.mesh.rank}")}


def _post(port, path, arrays=None):
    """(status, npz or JSON error) of one POST with an npz body."""
    body = b""
    if arrays is not None:
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        body = buf.getvalue()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", path, body=body)
        resp = conn.getresponse()
        data = resp.read()
    finally:
        conn.close()
    if resp.status != 200:
        return resp.status, json.loads(data)
    return resp.status, dict(np.load(io.BytesIO(data)))


def _requests():
    """The serving tests' requests, in order: (name, path, body)."""
    x = _serving_inputs(11, rows=SERVER_BATCH)
    rows = lambda n: {k: v[:n] for k, v in x.items()}  # noqa: E731
    return [("predict_1", "/predict", rows(1)),
            ("bad_shape", "/predict", {"visual": np.zeros((1, 32, 32, 3), np.float32)}),
            ("predict_4", "/predict", rows(4)),
            ("predict_sample", "/predict?sample=1", rows(3)),
            ("rollout", "/rollout?steps=3", rows(2)),
            ("rollout_odd", "/rollout?steps=2", rows(1)),
            ("prior", "/sample?n=3&seed=7", None)]


def _serve_requests(server, requests):
    """Every request's reply from ``server``, run in a thread, then closed."""
    port = server.server_port
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        return {name: _post(port, path, body) for name, path, body in requests}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def _server_ranks(state_dict):
    """Rank 0 serves the two-rank session over HTTP (micro-batching on) and
    posts ``_requests()`` to itself; rank 1 follows. Rank 0 returns the
    replies and the server's record, rank 1 the calls it made."""
    session = _serve_session(state_dict, _mesh(2))
    if session.mesh.rank:
        return follow(session)
    server = make_server(session, port=0, batch_size=SERVER_BATCH, microbatch_wait_ms=20.0)
    replies = _serve_requests(server, _requests())
    return {"replies": replies, "health": server.RequestHandlerClass.app.health()}


IDLE_TIMEOUT = 5        # s: the group timeout of the idle-server test


def _idle_server_ranks(state_dict):
    """A two-rank server idle for twice its group's timeout, then asked
    for one /predict: (rank 0's status, rank 1's calls). The pings every
    second keep rank 1's wait for the next header inside the timeout."""
    from datetime import timedelta

    from mmdyn_tpu_torch.serve import server as server_module

    server_module.KEEPALIVE_S = 1.0
    mesh = _mesh(2)
    session = _serve_session(state_dict, mesh)
    torch.distributed.barrier()         # both sessions built: no skew below
    group = torch.distributed.new_group(backend="gloo",
                                        timeout=timedelta(seconds=IDLE_TIMEOUT))
    session.mesh = dataclasses.replace(mesh, group=group, host_group=group)
    if mesh.rank:
        return follow(session)
    server = make_server(session, port=0, batch_size=SERVER_BATCH)
    time.sleep(2 * IDLE_TIMEOUT)
    requests = [("predict", "/predict", _serving_inputs(rows=2))]
    return _serve_requests(server, requests)["predict"][0]


LOOP = dict(problem_type="seq_modeling", model_name="cnn-mvae", input_type="visuotactile",
            use_pose=True, latent_size=8, batchsize=4, num_epochs=2, annealing_epochs=2)


def _stop_then_resume(ds, root):
    """A 2-epoch run of 2 ranks, and the same run asked to stop after
    optimizer step 6 on rank 1 only, then resumed: final parameters and
    validation losses of both, and where the stop fell."""
    mesh = _mesh(2)
    cfg = ProblemConfig(**LOOP)

    def problem(name, **kw):
        return Problem(cfg, ds, log_dir=f"{root}/{name}", tensorboard=False, mesh=mesh, **kw)

    def final(p):
        return {k: v.numpy().copy() for k, v in p.state.model.state_dict().items()}

    full = problem("full")
    full_val = full.train()["Loss/validation_epoch"]
    first = problem("stopped")
    step, count = first.train_step, [0]

    def stopping_step(*a):
        out = step(*a)
        count[0] += 1
        if count[0] == 6 and mesh.rank == 1:
            first._stop_requested = True
        return out

    first.train_step = stopping_step
    val = first.train()["Loss/validation_epoch"]
    second = problem("stopped", resume=True)
    where = (first._preempted, second._start_epoch, second._skip_batches)
    val += second.train()["Loss/validation_epoch"]
    return {"full": final(full), "full_val": full_val, "resumed": final(second),
            "resumed_val": val, "where": where}


# ----------------------------------------------------------------------
# the parent's side

@pytest.fixture(scope="module")
def jax_side():
    """The flax MVAE (latent 16, pose, no dropout), its weights as numpy,
    the batch as JAX arrays, and the weights in the port's layout."""
    import jax
    import jax.numpy as jnp

    from mmdyn_tpu.models import MVAE as JaxMVAE

    from mmdyn_tpu_torch.utils.weights import params_from_jax

    jbatch = {k: jnp.asarray(v) for k, v in _batch().items()}
    model = JaxMVAE(latent_size=LATENT, use_pose=True, dropout_rate=0.0)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), [jbatch["visual"][:, 0]] * 2,
                                    jbatch["pose"][:, 0])
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    sd = {k: v.numpy() for k, v in params_from_jax("cnn-mvae", params).items()}
    return model, params, jbatch, sd


def _jax_mesh_steps(jax_side, n):
    """Three Adam steps of the JAX package's step on ``make_mesh(n)``
    (noise-free): the losses and the first step's gradients in the port's
    layout."""
    import jax
    import jax.numpy as jnp

    from mmdyn_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from mmdyn_tpu.parallel.mesh import replicate as jax_replicate
    from mmdyn_tpu.parallel.mesh import shard_batch as jax_shard_batch
    from mmdyn_tpu.problems import ProblemConfig as JaxConfig
    from mmdyn_tpu.problems import make_optimizer as jax_make_optimizer
    from mmdyn_tpu.train import create_train_state as jax_create_train_state
    from mmdyn_tpu.train import make_train_step as jax_make_train_step
    from mmdyn_tpu.train.steps import _loss_fn as jax_loss_fn

    from mmdyn_tpu_torch.utils.weights import params_from_jax

    model, params, jbatch, _ = jax_side
    cfg = JaxConfig(problem_type="seq_modeling", model_name="cnn-mvae",
                    input_type="visuotactile", use_pose=True, latent_size=LATENT,
                    batchsize=B, noise_free=True)
    mesh = jax_make_mesh(n)
    sharded_batch = jax_shard_batch(mesh, jbatch)
    grads = jax.jit(jax.grad(lambda p: jax_loss_fn(p, model, cfg, sharded_batch,
                                                   jax.random.PRNGKey(1), 1.0)[0]))(
        jax_replicate(mesh, params))
    grads = params_from_jax("cnn-mvae", jax.tree_util.tree_map(np.asarray, grads))
    tx = jax_make_optimizer(cfg)
    # the step donates its state: a fresh copy of the weights
    state = jax_replicate(mesh, jax_create_train_state(
        jax.tree_util.tree_map(jnp.array, params), tx))
    step = jax_make_train_step(cfg, model, tx)
    losses = []
    for i in range(3):
        state, metrics = step(state, sharded_batch, jax.random.PRNGKey(i), jnp.float32(1.0))
        losses.append(float(metrics["loss"]))
    return losses, {k: v.numpy() for k, v in grads.items()}


@pytest.mark.parametrize("n", [2, 4])
def test_ranks_match_the_jax_mesh_step(jax_side, n):
    """The port's step in n processes from the JAX weights, noise-free and
    without dropout, against the JAX step on ``make_mesh(n)``: every rank's
    loss per step (rel 1e-4) and the first step's summed gradients (rtol
    1e-3), as test_torch_steps.py::test_adam_steps_match_jax holds one
    process."""
    losses, grads = _jax_mesh_steps(jax_side, n)
    ranks = spawn(_jax_weights_ranks, n, (n, jax_side[3]), timeout=TIMEOUT)
    for rank, got in enumerate(ranks):
        assert got["losses"] == pytest.approx(losses, rel=1e-4), rank
        for name, want in grads.items():
            np.testing.assert_allclose(got["grads"][name], want, rtol=1e-3,
                                       atol=1e-5 * np.abs(want).max(), err_msg=name)


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


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


@pytest.fixture(scope="module")
def served(jax_side):
    """Two ranks' sharded session from the JAX weights (``_serve``)."""
    return spawn(_serve_ranks, 2, (jax_side[3],), timeout=TIMEOUT)


def test_sharded_session_matches_the_jax_mesh_session(jax_side, served):
    """``InferenceSession(mesh=)`` over two ranks: every rank returns the
    whole batch's predictions, equal to the JAX session on ``make_mesh(2)``
    (atol 1e-5, as tests/test_serve.py:281)."""
    from mmdyn_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from mmdyn_tpu.problems.base import ProblemConfig as JaxConfig
    from mmdyn_tpu.serve import InferenceSession as JaxSession

    cfg = JaxConfig(problem_type="seq_modeling", model_name="cnn-mvae",
                    input_type="visuotactile", use_pose=True, latent_size=LATENT)
    want = JaxSession(cfg, jax_side[1], mesh=jax_make_mesh(2)).predict(
        **_serving_inputs())
    for res in served:
        got = res["predict"]
        for k in ("mu", "logvar", "visual", "tactile", "pose"):
            np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-5, err_msg=k)


def test_freeze_bn_across_ranks_matches_one_rank(jax_side, served):
    """``freeze_bn`` over two ranks (each calibrating on its rows, the
    statistics over both) gives the statistics and frozen predictions of
    one process calibrating on the whole batch (atol 1e-5)."""
    want = _serve(jax_side[3])
    for got in served:
        assert got["stats"].keys() == want["stats"].keys()
        for name, s in want["stats"].items():
            for k in ("mean", "var"):
                np.testing.assert_allclose(got["stats"][name][k], s[k], atol=1e-5,
                                           rtol=1e-5, err_msg=name)
        for k, v in want["frozen"].items():
            np.testing.assert_allclose(got["frozen"][k], v, atol=1e-5, err_msg=k)


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


@pytest.fixture(scope="module")
def jax8():
    """A flax MVAE at latent 8 (pose, no dropout): its config, parameters
    as numpy and its weights in the port's layout."""
    import jax
    import jax.numpy as jnp

    from mmdyn_tpu.problems.base import ProblemConfig as JaxConfig
    from mmdyn_tpu.serve import InferenceSession as JaxSession

    from mmdyn_tpu_torch.utils.weights import params_from_jax

    cfg = JaxConfig(problem_type="seq_modeling", model_name="cnn-mvae",
                    input_type="visuotactile", use_pose=True, latent_size=SERVE_LATENT)
    img = jnp.zeros((2, 64, 64, 3))
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("params", "dropout", "reparam"))}
    params = JaxSession(cfg, {}).model.init(rngs, [img, img], jnp.zeros((2, 7)), None)
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    sd = {k: v.numpy() for k, v in params_from_jax("cnn-mvae", params).items()}
    return cfg, params, sd


@pytest.fixture(scope="module")
def aot_exported(jax8, tmp_path_factory):
    """Two ranks' ``aot_predict(16)`` outputs and artifacts
    (``_aot_export_ranks``), and the root of the artifacts."""
    root = tmp_path_factory.mktemp("exports")
    return spawn(_aot_export_ranks, 2, (jax8[2], str(root)), timeout=TIMEOUT), root


def test_aot_predict_across_ranks_matches_the_jax_mesh(jax8, aot_exported):
    """``aot_predict(16)`` of a two-rank CPU session, which every rank calls
    with the whole batch: every rank returns the JAX ``aot_predict`` of a
    ``make_mesh(2)`` session within atol 1e-5 (tests/test_serve.py:281's
    bound)."""
    import jax

    from mmdyn_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from mmdyn_tpu.serve import InferenceSession as JaxSession

    cfg, params, _ = jax8
    session = JaxSession(cfg, params, mesh=jax_make_mesh(2))
    x = _serving_inputs(rows=AOT_ROWS)
    compiled = session.aot_predict(AOT_ROWS, ("visual", "tactile"))
    want = compiled(session.variables, {"visual": x["visual"], "tactile": x["tactile"]}, None,
                    jax.random.PRNGKey(0))
    for res in aot_exported[0]:
        assert set(res["aot"]) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(res["aot"][k], np.asarray(v), atol=1e-5, err_msg=k)


@pytest.mark.parametrize("frozen", [False, True], ids=["batch_bn", "frozen_bn"])
def test_export_across_ranks_equals_one_process(jax8, aot_exported, tmp_path, frozen):
    """``export_session`` of a two-rank session: rank 0 writes a one-device
    artifact and both ranks return its manifest. Its outputs equal the
    one-process artifact's bit for bit; frozen, the statistics were taken
    over both ranks' rows, and the outputs are held at the bound of
    ``test_freeze_bn_across_ranks_matches_one_rank`` (atol 1e-5)."""
    ranks, root = aot_exported
    name = "frozen_bn" if frozen else "batch_bn"
    assert ranks[0]["manifests"] == ranks[1]["manifests"]
    assert not (root / "rank1").exists()
    want_manifests = _export_both(_serve_session(jax8[2]), tmp_path)
    got_manifest = ranks[0]["manifests"][frozen]
    assert got_manifest == want_manifests[frozen] and got_manifest["frozen_bn"] is frozen
    x = {k: v[:EXPORT_ROWS] for k, v in _serving_inputs(3).items()}
    got = load_exported(root / "rank0" / name)(**x)
    want = load_exported(tmp_path / name)(**x)
    assert got.keys() == want.keys()
    for k, v in want.items():
        if frozen:
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=1e-5, err_msg=k)
        else:
            assert torch.equal(got[k], v), k


def _assert_replies_close(got, want, name):
    assert set(got) == set(want), name
    for k, w in want.items():
        g, w = np.asarray(got[k]), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (name, k, g.shape, w.shape)
        if w.dtype == np.uint8:
            assert np.abs(g.astype(int) - w.astype(int)).max() <= 1, (name, k)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=f"{name} {k}")


def test_server_across_ranks_matches_jax_and_one_process(jax8):
    """The HTTP server of a two-rank session (rank 0 serves and posts to
    itself, micro-batching on; rank 1 follows): a malformed request is
    refused on rank 0 and the ranks go on; /predict and /rollout equal the
    JAX server of a ``make_mesh(2)`` session, and every reply, the sampled
    ones too, the one-process port server's given the same requests in the
    same order (uint8 within 1, floats atol 1e-5). A rollout of one row runs
    padded to two, one per rank."""
    from mmdyn_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from mmdyn_tpu.serve import InferenceSession as JaxSession
    from mmdyn_tpu.serve.server import make_server as jax_make_server

    rank0, calls = spawn(_server_ranks, 2, (jax8[2],), timeout=TIMEOUT)
    got = rank0["replies"]
    assert rank0["health"]["ranks"] == 2 and rank0["health"]["microbatching"]
    # the warm-up's two predicts, then every request that reached the device
    assert calls == 2 + 5
    assert got["bad_shape"][0] == 400 and "visual must be" in got["bad_shape"][1]["error"]
    requests = _requests()
    one = _serve_requests(make_server(_serve_session(jax8[2]), port=0,
                                      batch_size=SERVER_BATCH), requests)
    cfg, params, _ = jax8
    deterministic = [r for r in requests if r[0] in ("predict_1", "predict_4", "rollout")]
    jax = _serve_requests(jax_make_server(JaxSession(cfg, params, mesh=jax_make_mesh(2)),
                                          port=0, batch_size=SERVER_BATCH), deterministic)
    for name, (status, want) in jax.items():
        assert status == got[name][0] == 200, name
        _assert_replies_close(got[name][1], want, name)
    for name, (status, want) in one.items():
        assert status == got[name][0], name
        if status == 200:
            _assert_replies_close(got[name][1], want, name)
    assert got["rollout_odd"][1]["visual"].shape == (2, 1, 64, 64, 3)


def test_idle_server_keeps_its_ranks(jax8):
    """A two-rank server idle for twice its group's timeout still answers:
    rank 0 pings the other ranks while idle (``KEEPALIVE_S``), whose wait
    for the next header would otherwise end in the group's timeout."""
    status, calls = spawn(_idle_server_ranks, 2, (jax8[2],), timeout=TIMEOUT)
    assert status == 200 and calls == 2 + 1


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
