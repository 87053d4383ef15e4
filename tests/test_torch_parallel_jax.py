"""The port's data parallelism (``mmdyn_tpu_torch/parallel``) on the CPU
against the JAX package's mesh: N gloo processes against ``make_mesh(n)``'s
step, session, ``aot_predict`` and server (over conftest's 8 host devices),
and the two-rank export and server against one process's. The shared
helpers and the rank functions are in ``tests/torch_parallel.py``.
"""

import numpy as np
import pytest
import torch

from mmdyn_tpu_torch.parallel import spawn
from mmdyn_tpu_torch.serve import load_exported
from mmdyn_tpu_torch.serve.server import make_server
from tests.torch_parallel import (AOT_ROWS, B, EXPORT_ROWS, LATENT, SERVE_LATENT,
                                  SERVER_BATCH, TIMEOUT, _aot_export_ranks, _batch,
                                  _export_both, _idle_server_ranks, _jax_weights_ranks,
                                  _requests, _serve, _serve_ranks, _serve_requests,
                                  _serve_session, _server_ranks, _serving_inputs)
from tests.torch_threads import one_torch_thread  # noqa: F401


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
