"""The shared side of the port's data-parallel tests
(``tests/test_torch_parallel_{jax,steps,cli}.py``): the batches, configs
and runs both sides compute, and the rank functions ``parallel.spawn``
starts.

Each test starts its own group of ranks by ``parallel.spawn`` around a
file rendezvous in a temporary directory, with a 120 s limit on the run and
on every collective, so a hang fails instead of eating the suite's time;
each group does one test's work, so it stays well inside the limit while
the suite's other workers load the host. The rank functions live here, at
module level (the spawned processes import this module, which pytest does
not collect), and import no JAX: only the test files' functions do.
"""

import contextlib
import dataclasses
import http.client
import io
import json
import threading
import time

import numpy as np
import torch

from mmdyn_tpu_torch.models import model_kwargs, setup_model
from mmdyn_tpu_torch.models.layers import bn_stats, train_batch_norm
from mmdyn_tpu_torch.parallel import (all_reduce_grads, make_mesh, reduce_metrics,
                                      shard_batch, sharded)
from mmdyn_tpu_torch.problems import ProblemConfig, make_optimizer
from mmdyn_tpu_torch.serve import InferenceSession, export_session
from mmdyn_tpu_torch.serve.server import follow, make_server
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


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()
