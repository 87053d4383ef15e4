"""Port parity: ``mmdyn_tpu_torch.serve`` (and the serving CLIs) against
``mmdyn_tpu.serve``.

Flax models are initialised from a seed, their parameters carried into the
port by ``params_from_jax``, and the same numpy inputs go through the JAX
``InferenceSession`` and the port's ``InferenceSession(..., device="cpu")``.

Tolerances: probabilities atol 1e-5; mu, logvar and pose rtol 1e-4 /
atol 1e-5; uint8 images differ by at most 1 on at most 0.1% of pixels; the
compiled corpus helpers bit-identical. Sampling draws cannot match (the JAX
and torch generators differ), so sampling is held on ``_decode`` of one
shared z and port-only below.

Port-only cases mirror ``tests/test_serve.py``: the fixed-batch predictor,
the ``torch.export`` artifact, HTTP end to end, request hardening, buckets,
micro-batching, ``from_run`` and the CLIs.
"""

import http.client
import io
import json
import pickle
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmdyn_tpu.cli import infer as jax_infer
from mmdyn_tpu.problems.base import ProblemConfig as JaxConfig
from mmdyn_tpu.serve import InferenceSession as JaxSession

from mmdyn_tpu_torch.cli import infer, serve
from mmdyn_tpu_torch.models import model_kwargs, setup_model
from mmdyn_tpu_torch.models.layers import bn_stats, load_bn_stats
from mmdyn_tpu_torch.problems.base import ProblemConfig, make_optimizer
from mmdyn_tpu_torch.serve import InferenceSession, export_session, load_exported
from mmdyn_tpu_torch.serve.server import ServingApp, _bucket, make_server
from mmdyn_tpu_torch.serve.session import _infer_condition_dim
from mmdyn_tpu_torch.train import create_train_state
from mmdyn_tpu_torch.train.checkpoint import save_checkpoint
from mmdyn_tpu_torch.utils.weights import bn_stats_from_jax, params_from_jax

LATENT, B, COND = 8, 3, 3
PROB_TOL = dict(rtol=0, atol=1e-5)
LATENT_TOL = dict(rtol=1e-4, atol=1e-5)

FAMILIES = {
    "mvae": dict(problem_type="seq_modeling", model_name="cnn-mvae",
                 input_type="visuotactile", use_pose=True),
    "mvae-nopose": dict(problem_type="seq_modeling", model_name="cnn-mvae",
                        input_type="visuotactile"),
    "cnn-vae": dict(problem_type="seq_modeling", model_name="cnn-vae", input_type="visual"),
    "mlp-vae": dict(problem_type="reconstruction", model_name="mlp-vae", input_type="visual"),
    "cond-mlp-vae": dict(problem_type="reconstruction", model_name="mlp-vae",
                         input_type="visual", conditional=True, condition_dim=COND),
    "cond-mvae": dict(problem_type="seq_modeling", model_name="cnn-mvae",
                      input_type="visuotactile", conditional=True, condition_dim=COND),
    "cond-regressor": dict(problem_type="regression", model_name="regressor",
                           input_type="visual", conditional=True, condition_dim=COND),
}


def _inputs(seed, b=B):
    rng = np.random.default_rng(seed)
    img = lambda: rng.uniform(size=(b, 64, 64, 3)).astype(np.float32)  # noqa: E731
    return {"visual": img(), "tactile": img(),
            "pose": rng.uniform(size=(b, 7)).astype(np.float32),
            "condition": rng.uniform(size=(b, COND)).astype(np.float32)}


def _jax_params(family):
    """A flax model of ``family`` at latent 8, initialised from seed 0."""
    cfg = JaxConfig(latent_size=LATENT, batchsize=B, **FAMILIES[family])
    model = JaxSession(cfg, {}).model
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("params", "dropout", "reparam"))}
    img = jnp.zeros((2, 64, 64, 3))
    rows = 6 if cfg.model_name == "mlp-vae" else 2     # the mlp fold: 3 rows per image
    cond = jnp.zeros((rows, COND)) if cfg.conditional else None
    if cfg.is_mvae:
        args = ([img, img], jnp.zeros((2, 7)) if cfg.use_pose else None, cond)
    else:
        args = (img, cond)
    params = model.init(rngs, *args)["params"]
    return cfg, jax.tree_util.tree_map(np.asarray, params)


_PAIRS = {}


def _pair(family):
    """(JAX session, port session on the CPU) with the same weights."""
    if family not in _PAIRS:
        jcfg, params = _jax_params(family)
        tcfg = ProblemConfig(latent_size=LATENT, batchsize=B, **FAMILIES[family])
        _PAIRS[family] = (JaxSession(jcfg, params),
                          InferenceSession(tcfg, params_from_jax(tcfg.model_name, params),
                                           device="cpu"))
    return _PAIRS[family]


def _assert_uint8_close(got, want):
    diff = np.abs(got.astype(np.int16) - np.asarray(want).astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())


def _assert_preds_close(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g, w = got[k].cpu().numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (k, g.shape, w.shape)
        if w.dtype == np.uint8:
            _assert_uint8_close(g, w)
        elif k in ("mu", "logvar", "pose"):
            np.testing.assert_allclose(g, w, **LATENT_TOL, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, **PROB_TOL, err_msg=k)


# --------------------------------------------------------------------------
# parity with the JAX session

@pytest.mark.parametrize("present", [("visual",), ("tactile",), ("pose",),
                                     ("visual", "tactile"), ("visual", "tactile", "pose")],
                         ids="+".join)
def test_predict_matches_jax(present):
    js, ts = _pair("mvae")
    x = {k: v for k, v in _inputs(1).items() if k in present}
    _assert_preds_close(ts.predict(**x), js.predict(**x))


def test_encode_matches_jax():
    js, ts = _pair("mvae")
    x = _inputs(2)
    del x["condition"]
    for g, w in zip(ts.encode(**x), js.encode(**x)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **LATENT_TOL)


def test_uint8_payload_matches_jax():
    js, ts = _pair("mvae")
    x = _inputs(3)
    del x["condition"]
    got = ts.predict(**x, uint8_images=True)
    assert got["visual"].dtype == torch.uint8
    _assert_preds_close(got, js.predict(**x, uint8_images=True))
    # the payload is round(probs * 255) of the float prediction, half to even
    f = ts.predict(**x)
    np.testing.assert_array_equal(
        got["visual"].numpy(), np.round(f["visual"].numpy() * 255).astype(np.uint8))


@pytest.mark.parametrize("family", ["cnn-vae", "mlp-vae", "cond-mlp-vae", "cond-mvae",
                                    "cond-regressor"])
def test_family_predict_matches_jax(family):
    js, ts = _pair(family)
    x = _inputs(4)
    kw = {"visual": x["visual"]}
    if family == "cond-mvae":
        kw.update(tactile=x["tactile"], condition=x["condition"])
    elif family == "cond-regressor":
        kw["condition"] = x["condition"]
    elif family == "cond-mlp-vae":
        # one condition per channel-plane row of the fold (3B rows)
        kw["condition"] = np.repeat(x["condition"], 3, axis=0)
    got = ts.predict(**kw)
    _assert_preds_close(got, js.predict(**kw))
    if "mlp" in family:
        assert tuple(got["mu"].shape) == (B, 3, LATENT)   # grouped per input row
    assert _infer_condition_dim(ts.cfg, ts.params) == ts.cfg.condition_dim


def test_rollout_matches_jax():
    js, ts = _pair("mvae")
    x = _inputs(5)
    del x["condition"]
    got = ts.rollout(3, **x)
    want = js.rollout(3, **x)
    assert tuple(got["visual"].shape) == (3, B, 64, 64, 3)
    _assert_preds_close(got, want)
    q = ts.rollout(3, **x, uint8_images=True)
    _assert_uint8_close(q["visual"].numpy(), np.asarray(js.rollout(3, **x, uint8_images=True)
                                                        ["visual"]))
    np.testing.assert_array_equal(q["mu"].numpy(), got["mu"].numpy())


def test_decode_of_a_shared_z_matches_jax():
    js, ts = _pair("mvae")
    z = np.random.default_rng(6).normal(size=(B, LATENT)).astype(np.float32)
    want = js._decode(js.variables, jnp.asarray(z), None, {"dropout": jax.random.PRNGKey(0)})
    with torch.inference_mode():
        got = ts._decode(torch.tensor(z), None)
    _assert_preds_close(got, want)


@pytest.fixture(scope="module")
def frozen_pair():
    """The JAX session frozen on a calibration batch of 8, and the port's
    session built from the JAX ``bn_stats`` by ``bn_stats_from_jax``."""
    js, ts = _pair("mvae")
    cal = _inputs(7, b=8)
    del cal["condition"]
    jf = js.freeze_bn(**cal)
    stats = bn_stats_from_jax("cnn-mvae", jax.tree_util.tree_map(np.asarray, jf.bn_stats))
    tf = InferenceSession(ts.cfg, ts.params, bn_stats=stats, device="cpu")
    return cal, jf, tf


def test_frozen_bn_from_jax_stats_matches_jax(frozen_pair):
    _, jf, tf = frozen_pair
    assert len(tf.bn_stats) == 12          # 3 per encoder, 3 per decoder
    x = _inputs(8)
    del x["condition"]
    _assert_preds_close(tf.predict(**x), jf.predict(**x))
    _assert_preds_close(tf.predict(visual=x["visual"]), jf.predict(visual=x["visual"]))
    # per-example: row 0 alone equals row 0 of the batch
    solo = tf.predict(visual=x["visual"][:1])
    full = tf.predict(visual=x["visual"])
    for k in ("mu", "visual"):
        np.testing.assert_allclose(solo[k].numpy(), full[k][:1].numpy(), rtol=1e-5, atol=1e-6)


def test_collect_pass_encoder_stats_match_jax(frozen_pair):
    cal, jf, _ = frozen_pair
    _, ts = _pair("mvae")
    own = ts.freeze_bn(**cal)
    want = bn_stats_from_jax("cnn-mvae", jax.tree_util.tree_map(np.asarray, jf.bn_stats))
    assert set(own.bn_stats) == set(want)
    enc = [n for n in want if "encoder" in n]
    assert len(enc) == 6
    for name in enc:
        for k in ("mean", "var"):
            np.testing.assert_allclose(own.bn_stats[name][k].numpy(), want[name][k].numpy(),
                                       **LATENT_TOL, err_msg=f"{name}.{k}")
    # the decoders' statistics follow a sampled z: held finite, not equal
    assert all(torch.isfinite(s["var"]).all() for s in own.bn_stats.values())
    # served on the calibration batch itself, frozen == batch statistics
    np.testing.assert_allclose(own.predict(**cal)["mu"].numpy(),
                               ts.predict(**cal)["mu"].numpy(), rtol=1e-4, atol=1e-5)


def test_from_torch_ckpt_matches_jax(tmp_path):
    from mmdyn_tpu.utils.torch_compat import to_torch_state_dict

    js, _ = _pair("mvae")
    sd = to_torch_state_dict("cnn-mvae", jax.tree_util.tree_map(np.asarray, js.params))
    assert any(k.endswith("running_mean") for k in sd)
    ckpt = tmp_path / "epoch_5.ckpt"
    torch.save({"model": {k: torch.tensor(np.ascontiguousarray(v)) for k, v in sd.items()},
                "loss": 1.0, "epoch": 5}, ckpt)
    ts = InferenceSession.from_torch_ckpt(ckpt, device="cpu")
    assert ts.cfg.latent_size == LATENT and ts.cfg.use_pose is True
    x = {"visual": _inputs(9)["visual"]}
    _assert_preds_close(ts.predict(**x), js.predict(**x))


def _write_dump(path, n=3, seed=0):
    """A sim-dump-like sequence: visual / tactile / seg PNGs and data.json."""
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


NORMS = {"pose_min": [0, 0, 0, -1, -1, -1, -1], "pose_max": [1, 2, 1, 1, 1, 1, 1]}


@pytest.mark.parametrize("crop", [True, False], ids=["crop", "nocrop"])
def test_load_frames_matches_jax(tmp_path, crop):
    dump = _write_dump(tmp_path / "seq")
    norms = dict(NORMS, crop=crop)
    mods = ("visual", "tactile", "pose")
    got = infer._load_frames(dump, mods, norms=norms)
    want = jax_infer._load_frames(dump, mods, norms=norms)
    assert set(got) == set(mods)
    for m in mods:
        np.testing.assert_array_equal(got[m], want[m])
    with pytest.raises(ValueError, match="--no-pose"):
        infer._load_frames(dump, mods, norms={})


# --------------------------------------------------------------------------
# port only

def test_batchnorm_modes():
    x = torch.rand(4, 64, 64, 3)
    batch = setup_model("cnn-vae", device="cpu", latent_size=LATENT, dropout_rate=0.0)
    collect = setup_model("cnn-vae", device="cpu", latent_size=LATENT, dropout_rate=0.0,
                          bn_mode="collect")
    frozen = setup_model("cnn-vae", device="cpu", latent_size=LATENT, dropout_rate=0.0,
                         bn_mode="frozen")
    sd = batch.state_dict()
    assert not any(k.endswith((".mean", ".var")) for k in sd)  # stats stay out of it
    collect.load_state_dict(sd, strict=True)
    frozen.load_state_dict(sd, strict=True)
    with torch.no_grad():
        want = batch.encoder(x)
        np.testing.assert_array_equal(collect.encoder(x)[0].numpy(), want[0].numpy())
        stats = {k: v for k, v in bn_stats(collect).items() if k.startswith("encoder")}
        load_bn_stats(frozen, {**bn_stats(frozen), **stats})
        got = frozen.encoder(x)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **LATENT_TOL)
    with pytest.raises(ValueError, match="do not match"):
        load_bn_stats(frozen, stats)
    with pytest.raises(ValueError, match="one group"):
        collect.decoder(torch.rand(2, 2, LATENT))


def test_aot_predict_equals_predict():
    _, ts = _pair("mvae")
    x = _inputs(10)
    fn = ts.aot_predict(B, ("visual", "tactile"), uint8_images=True)
    assert ts.aot_predict(B, ("tactile", "visual"), uint8_images=True) is fn   # cached
    got = fn({"visual": x["visual"], "tactile": x["tactile"]})
    want = ts.predict(visual=x["visual"], tactile=x["tactile"], uint8_images=True)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    with pytest.raises(ValueError, match="takes"):
        fn({"visual": x["visual"][:2], "tactile": x["tactile"][:2]})
    with pytest.raises(ValueError, match="modalities"):
        fn({"visual": x["visual"]})
    # sample: the noise is an input drawn from the session's generator
    s = ts.aot_predict(B, ("visual",), sample=True)
    a, b = s({"visual": x["visual"]}), s({"visual": x["visual"]})
    np.testing.assert_array_equal(a["mu"].numpy(), b["mu"].numpy())
    assert not torch.equal(a["visual"], b["visual"])


def test_sampling_draws_from_the_generator():
    _, ts = _pair("mvae")
    v = _inputs(11)["visual"]
    g = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    a = ts.predict(visual=v, sample=True, generator=g(1))
    b = ts.predict(visual=v, sample=True, generator=g(2))
    np.testing.assert_array_equal(a["mu"].numpy(), b["mu"].numpy())
    assert not np.allclose(a["visual"].numpy(), b["visual"].numpy())
    p1, p2 = ts.sample_prior(4, g(5)), ts.sample_prior(4, g(5))
    assert tuple(p1["visual"].shape) == (4, 64, 64, 3) and tuple(p1["pose"].shape) == (4, 7)
    np.testing.assert_array_equal(p1["visual"].numpy(), p2["visual"].numpy())


def test_parity_session_keeps_dropout_live():
    js, ts = _pair("mvae-nopose")
    live = InferenceSession(ts.cfg, ts.params, parity=True, device="cpu")
    v = _inputs(12)["visual"]
    a, b = live.predict(visual=v), live.predict(visual=v)
    assert not np.allclose(a["mu"].numpy(), b["mu"].numpy())


@pytest.mark.parametrize("case", ["no_modality", "wrong_stream", "needs_condition",
                                  "regression_rollout", "regression_sample"])
def test_session_rejects(case):
    x = _inputs(13)
    if case == "no_modality":
        with pytest.raises(ValueError):
            _pair("mvae")[1].predict()
    elif case == "wrong_stream":
        _, ts = _pair("cnn-vae")                # trained on visual
        with pytest.raises(ValueError, match="visual"):
            ts.predict(tactile=x["tactile"])
    elif case == "needs_condition":
        with pytest.raises(ValueError, match="conditional"):
            _pair("cond-mvae")[1].predict(visual=x["visual"])
    elif case == "regression_rollout":
        with pytest.raises(ValueError, match="generative"):
            _pair("cond-regressor")[1].rollout(2, visual=x["visual"], condition=x["condition"])
    else:
        with pytest.raises(ValueError, match="latent"):
            _pair("cond-regressor")[1].sample_prior(2)


def test_freeze_bn_warns_on_bn_free_model_and_freezes_the_regressor():
    _, mlp = _pair("mlp-vae")
    with pytest.warns(UserWarning, match="no BatchNorm"):
        assert mlp.freeze_bn(visual=_inputs(14)["visual"]) is mlp
    _, reg = _pair("cond-regressor")
    x = _inputs(15, b=4)
    frozen = reg.freeze_bn(visual=x["visual"], condition=x["condition"])
    assert len(frozen.bn_stats) == 3
    a = frozen.predict(visual=x["visual"][:1], condition=x["condition"][:1])
    b = frozen.predict(visual=x["visual"], condition=x["condition"])
    np.testing.assert_allclose(a["pose"].numpy(), b["pose"][:1].numpy(), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="visual AND tactile"):
        _pair("mvae")[1].freeze_bn(visual=x["visual"])


@pytest.mark.parametrize("frozen", [False, True], ids=["batch_bn", "frozen_bn"])
def test_export_roundtrip_and_manifest(tmp_path, frozen):
    _, ts = _pair("mvae")
    x = _inputs(16)
    if frozen:
        ts = ts.freeze_bn(visual=x["visual"], tactile=x["tactile"], pose=x["pose"])
    manifest = export_session(ts, tmp_path / "art", batch_size=B,
                              modalities=("visual", "tactile"), sample=frozen)
    with open(tmp_path / "art" / "manifest.json") as f:
        assert json.load(f) == manifest
    assert set(manifest) == {"batch_size", "modalities", "conditional", "sample", "platforms",
                             "outputs", "frozen_bn", "config", "torch_version"}
    assert manifest["platforms"] == ["cpu"] and manifest["frozen_bn"] is frozen
    assert manifest["outputs"] == ["logvar", "mu", "pose", "tactile", "visual"]
    assert manifest["config"]["model_name"] == "cnn-mvae" and manifest["batch_size"] == B
    pred = load_exported(tmp_path / "art")
    got = pred(visual=x["visual"], tactile=x["tactile"])
    if frozen:   # the artifact's default noise: a generator seeded with 0
        noise = torch.randn((B, LATENT), generator=torch.Generator().manual_seed(0))
        with torch.inference_mode():
            want = ts._predict_core({"visual": torch.tensor(x["visual"]),
                                     "tactile": torch.tensor(x["tactile"])}, None, noise)
    else:
        want = ts.predict(visual=x["visual"], tactile=x["tactile"])
    for k in manifest["outputs"]:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="modalities"):
        pred(visual=x["visual"])
    if not frozen:   # uint8 inputs are scaled by 1/255, as the server does
        q = {m: (x[m] * 255).astype(np.uint8) for m in ("visual", "tactile")}
        a = pred(**q)["mu"].numpy()
        b = ts.predict(**{m: q[m].astype(np.float32) / 255.0 for m in q})["mu"].numpy()
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_export_guards_a_single_modality_vae(tmp_path):
    _, ts = _pair("cnn-vae")
    with pytest.raises(ValueError, match="visual"):
        export_session(ts, tmp_path / "bad", batch_size=2, modalities=("tactile",))
    assert export_session(ts, tmp_path / "good", batch_size=2)["modalities"] == ["visual"]


def test_buckets():
    assert [_bucket(n) for n in (1, 2, 3, 5, 9, 1000)] == [1, 2, 4, 8, 16, 1024]


def _npz(**arrays):
    buf = io.BytesIO()
    np.savez(buf, **{k: np.asarray(v) for k, v in arrays.items()})
    return buf.getvalue()


def _request(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        if headers is None:
            conn.request(method, path, body=body)
        else:
            conn.putrequest(method, path)
            for k, v in headers.items():
                conn.putheader(k, v)
            conn.endheaders()
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


@pytest.fixture(scope="module")
def http_server():
    _, ts = _pair("mvae-nopose")
    server = make_server(ts, port=0, batch_size=4)     # port 0: OS-assigned
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield ts, server.server_port
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def test_http_end_to_end(http_server):
    ts, port = http_server
    status, data = _request(port, "GET", "/healthz")
    health = json.loads(data)
    assert status == 200 and health["status"] == "ok" and health["batch_size"] == 4
    assert health["frozen_bn"] is False and health["microbatching"] is False

    v = _inputs(17)["visual"]                # 3 < batch 4: pads, truncates back
    status, data = _request(port, "POST", "/predict", _npz(visual=v))
    out = np.load(io.BytesIO(data))
    assert status == 200 and out["visual"].dtype == np.uint8
    assert out["visual"].shape == (3, 64, 64, 3) and out["mu"].shape == (3, LATENT)
    # batch-statistics BN: the result is a function of the padded batch
    live = ts.predict(visual=np.concatenate([v, v[-1:]]), uint8_images=True)
    np.testing.assert_array_equal(out["visual"], live["visual"][:3].numpy())

    status, data = _request(port, "POST", "/rollout?steps=3",
                            _npz(visual=v[:1], tactile=v[:1]))
    traj = np.load(io.BytesIO(data))
    assert status == 200 and traj["visual"].shape == (3, 1, 64, 64, 3)
    assert traj["visual"].dtype == np.uint8

    status, data = _request(port, "POST", "/sample?n=3&seed=7", b"")
    a = np.load(io.BytesIO(data))
    status2, data2 = _request(port, "POST", "/sample?n=4&seed=7", b"")
    b = np.load(io.BytesIO(data2))
    assert (status, status2) == (200, 200) and a["visual"].shape == (3, 64, 64, 3)
    # n=3 and n=4 share bucket 4: the same draws per seed
    np.testing.assert_array_equal(a["visual"], b["visual"][:3])
    assert _request(port, "GET", "/nowhere")[0] == 404


@pytest.mark.parametrize("case", ["bad_shape", "unknown_key", "over_batch", "empty",
                                  "content_length_text", "content_length_huge", "oversize_n",
                                  "oversize_steps", "condition_to_unconditional"])
def test_request_hardening(http_server, case):
    _, port = http_server
    zeros = lambda b, s=64: np.zeros((b, s, s, 3), np.float32)  # noqa: E731
    path, body, headers, match = "/predict", None, None, None
    if case == "bad_shape":
        body, match = _npz(visual=zeros(2, 32)), "visual must be"
    elif case == "unknown_key":
        body = _npz(bogus=np.zeros((2, 2)))
    elif case == "over_batch":
        body, match = _npz(visual=zeros(9)), "exceeds serving batch"
    elif case == "empty":
        body, match = _npz(visual=zeros(0)), "empty"
    elif case == "content_length_text":
        headers, match = {"Content-Length": "banana"}, "Content-Length"
    elif case == "content_length_huge":
        headers, match = {"Content-Length": str(1 << 40)}, "outside"
    elif case == "oversize_n":
        path, body, match = "/sample?n=100000", b"", "n must be"
    elif case == "oversize_steps":
        path, body, match = "/rollout?steps=5000", _npz(visual=zeros(1)), "steps"
    else:
        body = _npz(visual=zeros(1), condition=np.zeros((1, 3), np.float32))
        match = "not conditional"
    status, data = _request(port, "POST", path, body, headers)
    assert status == 400, data
    if match:
        assert match in json.loads(data)["error"]


@pytest.fixture(scope="module")
def frozen_session():
    _, ts = _pair("mvae-nopose")
    cal = _inputs(18, b=8)
    return ts.freeze_bn(visual=cal["visual"], tactile=cal["tactile"])


def test_microbatching_coalesces_and_matches_solo(frozen_session):
    app = ServingApp(frozen_session, batch_size=4, microbatch_wait_ms=300.0)
    vs = [_inputs(20 + i, b=1)["visual"] for i in range(3)]
    results = [None] * 3

    def post(i):
        results[i] = np.load(io.BytesIO(app.predict(_npz(visual=vs[i]))))

    threads = [threading.Thread(target=post, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert app._batches < 3 and app._requests == 3     # coalesced
    solo = ServingApp(frozen_session, batch_size=4)
    for i in range(3):   # frozen BN at one padded batch shape: row for row
        want = np.load(io.BytesIO(solo.predict(_npz(visual=vs[i]))))
        for k in want:
            np.testing.assert_array_equal(results[i][k], want[k])


def test_microbatching_mixed_signatures_all_served(frozen_session):
    app = ServingApp(frozen_session, batch_size=4, microbatch_wait_ms=150.0)
    done = {}
    reqs = [(i, {"visual": _inputs(30 + i, b=1)["visual"]} if i % 2 == 0
             else {"visual": _inputs(30 + i, b=1)["visual"],
                   "tactile": _inputs(40 + i, b=1)["tactile"]}) for i in range(4)]

    def post(i, arrays):
        done[i] = np.load(io.BytesIO(app.predict(_npz(**arrays))))

    threads = [threading.Thread(target=post, args=r) for r in reqs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert sorted(done) == [0, 1, 2, 3] and app._requests == 4
    assert all(done[i]["visual"].shape == (1, 64, 64, 3) for i in done)


def test_uint8_request_payload_accepted():
    _, ts = _pair("mvae-nopose")
    app = ServingApp(ts, batch_size=2)
    v8 = (_inputs(19, b=2)["visual"] * 255).astype(np.uint8)
    out = np.load(io.BytesIO(app.predict(_npz(visual=v8))))
    ref = ts.predict(visual=v8.astype(np.float32) / 255.0, uint8_images=True)
    np.testing.assert_array_equal(out["visual"], ref["visual"].numpy())


def _fake_run(path, family="mvae", norms=None):
    """A run directory as the port's training CLI leaves it: problem.pkl, a
    ``latest`` checkpoint and, when given, norms.json."""
    _, ts = _pair(family)
    model = setup_model(ts.cfg.model_name, cross_modal=ts.cfg.cross_modal, device="cpu",
                        **model_kwargs(ts.cfg))
    model.load_state_dict(ts.params)
    (path / "checkpoint").mkdir(parents=True)
    save_checkpoint(path / "checkpoint",
                    create_train_state(model, make_optimizer(ts.cfg, model.parameters())),
                    0, 1.0, name="latest")
    saved = {k: getattr(ts.cfg, k) for k in ("problem_type", "model_name", "input_type",
                                              "use_pose", "conditional", "latent_size")}
    with open(path / "problem.pkl", "wb") as f:
        pickle.dump(dict(saved, dataset_path="unused"), f)
    if norms is not None:
        with open(path / "norms.json", "w") as f:
            json.dump(norms, f)
    return path, ts


@pytest.mark.parametrize("norms", ["recorded", "recorded_null", "probed"])
def test_from_run_condition_dim(tmp_path, norms):
    if norms == "recorded_null":
        run, ts = _fake_run(tmp_path / "run", "mvae", {"condition_dim": None})
        assert InferenceSession.from_run(run, device="cpu").cfg.condition_dim is None
        return
    recorded = {"condition_dim": COND, "compute_dtype": "float32"} if norms == "recorded" \
        else {"seq_length": 2}
    run, ts = _fake_run(tmp_path / "run", "cond-mvae", recorded)
    s = InferenceSession.from_run(run, device="cpu")
    assert s.cfg.condition_dim == COND and s.cfg.compute_dtype == "float32"
    x = _inputs(50)
    got = s.predict(visual=x["visual"], condition=x["condition"])
    want = ts.predict(visual=x["visual"], condition=x["condition"])
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_from_run_norms_and_checkpoint_errors(tmp_path):
    run, _ = _fake_run(tmp_path / "run", "mvae", dict(NORMS, seq_length=2))
    s = InferenceSession.from_run(run, device="cpu")
    raw = np.array([[0.5, 1.0, 0.25, 0.0, 0.0, 0.0, 1.0]], np.float32)
    np.testing.assert_allclose(s.denormalize_pose(s.normalize_pose(raw)), raw, rtol=1e-6)
    np.testing.assert_allclose(s.normalize_pose(raw)[0, :3], [0.5, 0.5, 0.25])
    bare, _ = _fake_run(tmp_path / "bare")
    with pytest.raises(ValueError, match="normalisation"):
        InferenceSession.from_run(bare, device="cpu").denormalize_pose(raw)
    empty = tmp_path / "empty"
    (empty / "checkpoint").mkdir(parents=True)
    with open(empty / "problem.pkl", "wb") as f:
        pickle.dump({"problem_type": "seq_modeling", "model_name": "cnn-mvae",
                     "input_type": "visuotactile"}, f)
    with pytest.raises(FileNotFoundError):
        InferenceSession.from_run(empty, device="cpu")


def test_from_run_of_a_jax_run_names_the_route(tmp_path):
    from mmdyn_tpu.problems.base import make_optimizer as jax_make_optimizer
    from mmdyn_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
    from mmdyn_tpu.train.state import create_train_state as jax_create_train_state

    js, _ = _pair("mvae")
    run = tmp_path / "jax_run"
    (run / "checkpoint").mkdir(parents=True)
    state = jax_create_train_state(js.params, jax_make_optimizer(js.cfg))
    jax_save_checkpoint(run / "checkpoint", state, 0, 1.0, name="latest")
    with open(run / "problem.pkl", "wb") as f:
        pickle.dump({"problem_type": "seq_modeling", "model_name": "cnn-mvae",
                     "input_type": "visuotactile", "use_pose": True, "latent_size": LATENT}, f)
    with pytest.raises(ValueError, match="orbax") as err:
        InferenceSession.from_run(run, device="cpu")
    assert "tools/export_torch_ckpt.py" in str(err.value)
    assert "from_torch_ckpt" in str(err.value)


@pytest.mark.parametrize("cli", [infer, serve], ids=["infer", "serve"])
def test_cli_requires_exactly_one_source(cli, monkeypatch):
    with pytest.raises(SystemExit):
        cli.main(["--frames", "x"] if cli is infer else [])
    with pytest.raises(SystemExit):
        cli.main(["--run", "a", "--torch-ckpt", "b"])
    if cli is serve:   # the HTTP server on several ranks is not ported
        with pytest.raises(NotImplementedError, match="several cards"):
            cli.main(["--run", "a", "--num-devices", "2"])
    else:              # infer spawns one rank per card: on one card, an error
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(RuntimeError, match="asks for 2 CUDA devices, but 1 is visible"):
            cli.main(["--run", "a", "--num-devices", "2"])


def test_infer_cli_on_the_cpu(tmp_path):
    run, ts = _fake_run(tmp_path / "run", "mvae", dict(NORMS, crop=True))
    dump = _write_dump(tmp_path / "seq")
    base = ["--run", str(run), "--platform", "cpu", "--batchsize", "2"]
    report = infer.main(base + ["--frames", str(dump), "--out", str(tmp_path / "out")])
    assert report["n_frames"] == 3 and "frames_per_s" in report   # 2 + a padded tail of 1
    assert len(list((tmp_path / "out").glob("pred_visual_*.png"))) == 3
    report = infer.main(base + ["--frames", str(dump), "--out", str(tmp_path / "roll"),
                                "--rollout", "2", "--calibrate", str(dump)])
    assert report["rollout_steps"] == 2
    assert len(list((tmp_path / "roll").glob("rollout_tactile_*.png"))) == 2
    manifest = infer.main(base + ["--export", str(tmp_path / "art")])
    assert manifest["modalities"] == ["tactile", "visual"] and manifest["batch_size"] == 2
    frames = infer._load_frames(dump, ("visual", "tactile"), norms=ts.norms)
    got = load_exported(tmp_path / "art")(**{m: frames[m][:2] for m in frames})
    want = ts.predict(**{m: frames[m][:2] for m in frames})
    np.testing.assert_allclose(got["mu"].numpy(), want["mu"].numpy(), rtol=0, atol=1e-5)


def test_entry_points_want_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points take it")
    run, ts = _fake_run(tmp_path / "run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceSession(ts.cfg, ts.params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceSession.from_run(run)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer.main(["--run", str(run), "--export", str(tmp_path / "art")])
