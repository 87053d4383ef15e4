"""Port parity: the simulator (``mmdyn_tpu_torch.sim``) against
``mmdyn_tpu.sim`` on the CPU, on the same seeded scenes.

* The numpy host modules the port copies (camera, AnalyticBackend, the
  tactile sensor) equal their JAX-package originals bit for bit;
  ``illumination_torch`` holds against ``illumination_jax`` at rtol 1e-5.
* ``SimulatorTorch`` against ``SimulatorJax`` on the scenes of
  ``tests/test_physics_jax.py``: trajectories within atol 1e-4, resting
  contact forces within rtol 1e-4 (both float32, other summation orders), and
  both within that file's tolerances of the float64 host engine.
* ``RaycastTorch`` against ``RaycastJax`` on the scenes of
  ``tests/test_raycast_jax.py`` (96 x 72): seg equal on >= 99.9% of pixels;
  where seg agrees, depth within atol 1e-5 and RGB, depth_png and seg_png
  within 1.
* ``TactileRendererTorch`` against ``TactileRendererJax`` on the scene of
  ``tests/test_tactile_jax.py`` (640 x 480, ``make_sensor``'s camera): within
  1 uint8 on >= 99.99% of pixels, and against the host pipeline at that
  file's bounds.
"""

import numpy as np
import pytest
import torch

from mmdyn_tpu.sim import camera as jcamera
from mmdyn_tpu.sim import config as jconfig
from mmdyn_tpu.sim import physics as jphysics
from mmdyn_tpu.sim import sensor as jsensor
from mmdyn_tpu.sim.physics_jax import pack_scene as jax_pack_scene
from mmdyn_tpu.sim.raycast_jax import RaycastJax
from mmdyn_tpu.sim.raycast_jax import capture_scene as jax_capture_scene
from mmdyn_tpu.sim.shader import illumination_jax
from mmdyn_tpu.sim.tactile_jax import TactileRendererJax

from mmdyn_tpu_torch.sim import camera as tcamera
from mmdyn_tpu_torch.sim import config as tconfig
from mmdyn_tpu_torch.sim import physics as tphysics
from mmdyn_tpu_torch.sim import sensor as tsensor
from mmdyn_tpu_torch.sim.physics_torch import pack_scene
from mmdyn_tpu_torch.sim.raycast_torch import RaycastTorch, capture_scene
from mmdyn_tpu_torch.sim.shader import illumination_torch
from mmdyn_tpu_torch.sim.tactile_torch import TactileRendererTorch
from tests.torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"


# --- host modules --------------------------------------------------------------


def _cameras(eye=(0.4, -0.3, 2.5)):
    out = []
    for mod in (jcamera, tcamera):
        cam = mod.Camera(width=96, height=72)
        cam.set_projection_matrix(fovy=55, aspect=96 / 72, near=0.2, far=9)
        cam.set_view_matrix(list(eye), [0.1, 0.0, 0.0], [0, 1, 0])
        out.append(cam)
    return out


def test_camera_matrices_and_conversions_equal_jax():
    jc, tc = _cameras()
    assert np.array_equal(tc.view_matrix, jc.view_matrix)
    assert np.array_equal(tc.projection_matrix, jc.projection_matrix)
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, size=(3, 50))
    pix = np.concatenate([rng.uniform(0, 96, (1, 50)), rng.uniform(0, 72, (1, 50)),
                          rng.uniform(0.2, 9, (1, 50))])
    for f, x in (("project_3D_to_pixel", pts), ("unproject_pixel_to_3D", pix),
                 ("real_depth_to_buffer", pix[2]), ("depth_buffer_to_real", pix[2] / 9),
                 ("normalize_depth", pix[2]), ("denormalize_depth", pix[2] / 9)):
        assert np.array_equal(getattr(tc, f)(x), getattr(jc, f)(x)), f
    depth = rng.uniform(0, 1, (72, 96))
    rgb = rng.integers(0, 256, (72, 96, 4))
    for a, b in zip(tc.unproject_canvas_to_pointcloud(rgb, depth),
                    jc.unproject_canvas_to_pointcloud(rgb, depth)):
        assert np.array_equal(a, b)
    assert np.array_equal(tcamera.look_at([1, 2, 3], [0, 0, 0], [0, 0, 1]),
                          jcamera.look_at([1, 2, 3], [0, 0, 0], [0, 0, 1]))
    assert tconfig.TIME_STEP == jconfig.TIME_STEP


def _scene(mod):
    """The scene of tests/test_raycast_jax.py, plus a falling sphere."""
    be = mod.AnalyticBackend()
    be.add_sphere(0.4, [0.3, -0.2, 0.8], color=(1, 0, 0))
    be.add_box([0.3, 0.2, 0.25], [-0.5, 0.3, 0.6], orientation=[0.2, 0.1, 0.3, 0.927],
               color=(0, 1, 0), fixed=True)
    be.add_box([0.2, 0.4, 0.1], [0.4, 0.6, 0.3], color=(0.2, 0.4, 0.9))
    be.add_sphere(0.1, [-0.45, 0.3, 1.4], color=(0.9, 0.9, 0.1), mass=0.5)
    return be


def test_analytic_backend_steps_and_renders_as_jax():
    jb, tb = _scene(jphysics), _scene(tphysics)
    for t in range(150):
        if t % 40 == 0:
            for b in (jb, tb):
                b.apply_external_force(3, [4.0, -2.0, 0.0])
        jb.step()
        tb.step()
    for bid in jb.bodies:
        assert np.array_equal(tb.bodies[bid].position, jb.bodies[bid].position)
        assert np.array_equal(tb.bodies[bid].velocity, jb.bodies[bid].velocity)
    for bid in jb.bodies:
        assert [vars(c) for c in tb.contacts(bid)] == [vars(c) for c in jb.contacts(bid)]
    jc, tc = _cameras()
    jc.set_backend(jb)
    tc.set_backend(tb)
    for a, b in zip(tc.get_raytraced_image(), jc.get_raytraced_image()):
        assert np.array_equal(a, b)


def _tactile_scene(mod, sensor_mod):
    """The scene of tests/test_tactile_jax.py: a sphere resting on the
    sensor after 400 steps."""
    backend = mod.AnalyticBackend()
    sensor = sensor_mod.make_sensor(backend, size=[1.5, 1.5, 1.0], position=[0, 0, 0.5],
                                    sensor_vector=[0, 0, 1], thickness=0.05)
    backend.add_sphere(0.15, [0.05, -0.1, 1.4], mass=0.5)
    for _ in range(400):
        backend.step()
    return backend, sensor


@pytest.fixture(scope="module")
def tactile_scenes():
    """(jax backend, jax sensor, port backend, port sensor) of the tactile
    scene."""
    jb, js = _tactile_scene(jphysics, jsensor)
    tb, ts = _tactile_scene(tphysics, tsensor)
    return jb, js, tb, ts


def test_tactile_sensor_images_equal_jax(tactile_scenes):
    _, js, _, ts = tactile_scenes
    got, want = ts.get_sensor_image(), js.get_sensor_image()
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    _, rgb_clip, depth_clip, _, _ = want
    t_img = ts.get_tactile_image(rgb_clip, depth_clip,
                                 ts.get_sensor_pointcloud(rgb_clip, depth_clip))
    j_img = js.get_tactile_image(rgb_clip, depth_clip,
                                 js.get_sensor_pointcloud(rgb_clip, depth_clip))
    assert t_img.shape == (480, 640, 4) and np.array_equal(t_img, j_img)
    assert float(ts.max_buffer_depth) == float(js.max_buffer_depth)
    assert ts.contacts.total_force(2) == js.contacts.total_force(2) > 0


def test_illumination_torch_matches_jax():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1, 1, (3, 400)).astype(np.float32)
    nrm = rng.normal(size=(3, 400)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=0)
    viewer = np.array([[0.1], [0.2], [2.0]], np.float32)
    dirs = rng.normal(size=(4, 3, 1)).astype(np.float32)
    i_d = rng.uniform(0, 2, (4, 3, 1)).astype(np.float32)
    i_s = rng.uniform(0, 2, (4, 3, 1)).astype(np.float32)
    consts = (1.0, 0.5, 0.8, 1.0, 5)
    want = np.asarray(illumination_jax(pts, nrm, viewer, dirs, i_d, i_s, *consts))
    got = illumination_torch(*(torch.from_numpy(a) for a in (pts, nrm, viewer, dirs, i_d, i_s)),
                             *consts)
    assert got.shape == (3, 400)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


# --- SimulatorTorch -------------------------------------------------------------


def _exp1_backend(mod, obj="sphere", orientation=(0, 0, 0, 1), sensor_mass=10000,
                  obj_pos=(0.0, 0.0, 1.5)):
    """tests/test_physics_jax.py's exp_1 / exp_3 scene."""
    b = mod.AnalyticBackend(time_step=jconfig.TIME_STEP)
    b.add_box([0.75, 0.75, 0.5], [0, 0, 0.5], mass=sensor_mass, color=(1, 0.6, 0),
              fixed=sensor_mass >= 1000)
    if obj == "sphere":
        b.add_sphere(0.15, obj_pos, mass=1, color=(0.3, 0.8, 0.4))
    else:
        b.add_box([0.12, 0.08, 0.16], obj_pos, orientation=orientation, mass=1,
                  color=(0.3, 0.8, 0.4))
    return b


def _host_rollout(b, n_steps, forces=None):
    """Pre-step poses of every body and the sensor <-> object pair force."""
    ids = sorted(b.bodies)
    traj = np.zeros((n_steps, len(ids), 3))
    force = np.zeros(n_steps)
    for t in range(n_steps):
        for r, bid in enumerate(ids):
            traj[t, r] = b.bodies[bid].position
        if forces is not None:
            for bid, f in forces(t):
                b.apply_external_force(bid, f)
        b.step()
        force[t] = sum(c.normal_force for c in b._contacts if {c.body_a, c.body_b} == {1, 2})
    return traj, force


def _rollouts(build, n_steps, ext=None):
    """(host traj, host force, (jax sim, traj, cf), (port sim, traj, cf))."""
    traj_h, force_h = _host_rollout(build(jphysics), n_steps,
                                    forces=None if ext is None else ext[1])
    out = []
    for pack, mod in ((jax_pack_scene, jphysics), (pack_scene, tphysics)):
        kw = {} if pack is jax_pack_scene else {"device": CPU}
        sim, _, consts = pack(build(mod), **kw)
        tile = lambda a: np.asarray(a)[None]  # noqa: E731
        res = sim.simulate(tile(consts["pos"]), tile(consts["vel"]), tile(consts["quat"]),
                           tile(consts["sizes"]), tile(consts["mass"]), n_steps,
                           ext_forces=None if ext is None else ext[0])
        out.append((sim, np.asarray(res["pos"])[0], np.asarray(res["contact_force"])[0]))
    return traj_h, force_h, out[0], out[1]


def _random_quat(seed):
    x = np.random.default_rng(seed).random(3)
    return [np.sqrt(1 - x[0]) * np.sin(2 * np.pi * x[1]),
            np.sqrt(1 - x[0]) * np.cos(2 * np.pi * x[1]),
            np.sqrt(x[0]) * np.sin(2 * np.pi * x[2]),
            np.sqrt(x[0]) * np.cos(2 * np.pi * x[2])]


@pytest.mark.parametrize("obj", ["sphere", "box"])
def test_exp1_drop_matches_jax_and_host(obj):
    q = _random_quat(3)
    traj_h, force_h, (jsim, traj_j, cf_j), (tsim, traj_t, cf_t) = _rollouts(
        lambda mod: _exp1_backend(mod, obj, orientation=q), 300)
    assert tsim.movable == jsim.movable == (False, False, True)
    assert cf_t.shape == cf_j.shape == (300, 3, 2 if obj == "sphere" else 3)
    np.testing.assert_allclose(traj_t, traj_j, atol=1e-4)
    slot = tsim.support_slot(1)
    assert slot == jsim.support_slot(1)
    np.testing.assert_allclose(cf_t[-50:, 2, slot], cf_j[-50:, 2, slot], rtol=1e-4)
    np.testing.assert_array_equal(cf_t[:, :2], 0.0)
    for traj, cf in ((traj_t, cf_t), (traj_j, cf_j)):
        # test_physics_jax.py's bounds against the float64 host engine
        np.testing.assert_allclose(traj, traj_h, atol=2e-3)
        np.testing.assert_allclose(traj[-1], traj_h[-1], atol=5e-4)
        np.testing.assert_allclose(cf[-50:, 2, slot], force_h[-50:], rtol=1e-4)


@pytest.mark.parametrize("shock,n_steps,host_atol", [
    ((55.0, -40.0, 0.0), 400, 5e-3),      # exp_3: the movable sensor under the object
    ((8000.0, 0.0, 0.0), 500, 5e-3),      # the support drags its rider
])
def test_exp3_shocked_movable_sensor_matches_jax_and_host(shock, n_steps, host_atol):
    shock = np.array(shock)
    ext = np.zeros((1, n_steps, 3, 3), np.float32)
    ext[0, 130:161, 1] = shock
    traj_h, _, (jsim, traj_j, cf_j), (tsim, traj_t, cf_t) = _rollouts(
        lambda mod: _exp1_backend(mod, "box", sensor_mass=100, obj_pos=(0.0, 0.0, 1.3)),
        n_steps, ext=(ext, lambda t: [(1, shock)] if 130 <= t <= 160 else []))
    assert tsim.movable == jsim.movable == (False, True, True)
    np.testing.assert_allclose(traj_t, traj_j, atol=1e-4)
    np.testing.assert_allclose(cf_t[-50:], cf_j[-50:], rtol=1e-4)
    for traj in (traj_t, traj_j):
        np.testing.assert_allclose(traj, traj_h, atol=host_atol)
        assert np.abs(traj).max() < 10.0


def test_batched_trials_equal_their_rows_alone():
    """A K=4 batch of trials equals each trial run alone, bit for bit."""
    k = 4
    sim, _, consts = pack_scene(_exp1_backend(tphysics, "box"), device=CPU)
    quats = np.tile(consts["quat"][None], (k, 1, 1))
    for i in range(k):
        quats[i, 2] = _random_quat(7 + i)
    tile = lambda a: np.tile(np.asarray(a)[None], (k,) + (1,) * a.ndim)  # noqa: E731
    ext = np.random.default_rng(2).normal(0, 5, size=(k, 120, 3, 3)).astype(np.float32)
    out = sim.simulate(tile(consts["pos"]), tile(consts["vel"]), quats, tile(consts["sizes"]),
                       tile(consts["mass"]), 120, ext_forces=ext)
    for i in range(k):
        single = sim.simulate(consts["pos"][None], consts["vel"][None], quats[i][None],
                              consts["sizes"][None], consts["mass"][None], 120,
                              ext_forces=ext[i][None])
        for key in out:
            assert torch.equal(out[key][i], single[key][0]), key


def test_device_entry_points_want_a_card(monkeypatch):
    """Without ``device="cpu"`` the device modules want the card; a tensor on
    another device than the module's is refused, not moved."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    be = _exp1_backend(tphysics)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pack_scene(be)
    cam = _cameras()[1]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RaycastTorch.from_camera(cam)
    sim, _, c = pack_scene(be, device=CPU)
    meta = torch.zeros(1, 3, 3, device="meta")
    with pytest.raises(ValueError, match="meta"):
        sim.simulate(meta, c["vel"][None], c["quat"][None], c["sizes"][None],
                     c["mass"][None], 2)
    _, ts = _tactile_scene(tphysics, tsensor)
    ts.get_sensor_image()
    renderer = TactileRendererTorch.from_sensor(ts, device=CPU)
    with pytest.raises(ValueError, match="meta"):
        renderer(torch.zeros(1, 480, 640, device="meta"))


def test_an_indexless_card_is_the_current_card(monkeypatch):
    """``resolve_device`` gives ``cuda``; the card's tensors lie on
    ``cuda:0``: the device check takes them as one device."""
    from mmdyn_tpu_torch.utils.device import same_device

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    card = torch.device("cuda")
    assert same_device(torch.device("cuda:0"), card) and same_device(card, card)
    assert not same_device(torch.device("cuda:1"), card)
    assert not same_device(torch.device("cpu"), card)


# --- RaycastTorch ---------------------------------------------------------------


def _raycast_camera(be, mod, eye=(0, 0, 3.0)):
    cam = mod.Camera(width=96, height=72, backend=be)
    cam.set_projection_matrix(fovy=60, aspect=96 / 72, near=0.3, far=8)
    cam.set_view_matrix(list(eye), [0, 0, 0], [0, 1, 0])
    return cam


def _raycast_scene(mod, kind):
    be = mod.AnalyticBackend()
    if kind != "empty":
        be.add_sphere(0.4, [0.3, -0.2, 0.8], color=(1, 0, 0))
        be.add_box([0.3, 0.2, 0.25], [-0.5, 0.3, 0.6], orientation=[0.2, 0.1, 0.3, 0.927],
                   color=(0, 1, 0))
        be.add_box([0.2, 0.4, 0.1], [0.4, 0.6, 0.3], color=(0.2, 0.4, 0.9))
    return be


def _frames(kind):
    """Host renders, camera states and the scene of ``kind`` (the three
    scenes of tests/test_raycast_jax.py), from the JAX package's host code."""
    be = _raycast_scene(jphysics, kind)
    eyes = {"static": [(0, 0, 3.0)], "empty": [(0, 0.5, 2.0)],
            "moving": [(0, 0, 3.0), (0.5, 0.4, 2.8), (-0.6, 0.2, 3.2)]}[kind]
    hosts, cams, frames = [], [], []
    for k, eye in enumerate(eyes):
        if kind == "moving":
            be.bodies[1].position = np.array([0.3, -0.2, 0.8 - 0.1 * k])
            be.bodies[2].orientation = np.array([0.2, 0.1 + 0.05 * k, 0.3, 0.927])
        cam = _raycast_camera(be, jcamera, eye)
        hosts.append(be.render(cam))
        cams.append(RaycastJax.capture_camera_state(cam))
        _, static, frame = jax_capture_scene(be)
        frames.append(frame)
    states = {"m_inv": np.stack([c[0] for c in cams]), "eye": np.stack([c[1] for c in cams]),
              "forward": np.stack([c[2] for c in cams])}
    scene = dict(static)
    for key in ("sph_pos", "box_pos", "box_q"):
        scene[key] = np.stack([f[key] for f in frames])
    return be, cam, hosts, states, scene


def _assert_close_frames(got_seg, want_seg, pairs, seg_share=0.999):
    """Seg equal on ``seg_share`` of pixels; each (got, want, atol) pair
    within atol where seg agrees."""
    agree = got_seg == want_seg
    assert agree.mean() >= seg_share, agree.mean()
    for got, want, atol in pairs:
        a = agree if got.ndim == agree.ndim else agree[..., None]
        a = np.broadcast_to(a, got.shape)
        gap = np.abs(got.astype(np.float64) - want.astype(np.float64))[a]
        assert gap.max(initial=0.0) <= atol, (gap.max(), atol)


@pytest.mark.parametrize("kind", ["static", "moving", "empty"])
def test_raycast_matches_jax_and_host(kind):
    be, cam, hosts, states, scene = _frames(kind)
    for got, want in zip(capture_scene(be), jax_capture_scene(be)):
        if isinstance(want, dict):
            assert sorted(got) == sorted(want)
            for key in want:
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        else:
            assert got == want
    want = [np.asarray(x) for x in RaycastJax.from_camera(cam).render_frames(states, scene)]
    rc = RaycastTorch.from_camera(cam, device=CPU)
    got = [x.numpy() for x in rc.render_frames(states, scene)]
    assert [g.dtype for g in got] == [np.uint8, np.float32, np.int32]
    assert got[0].shape == (len(hosts), 72, 96, 4) and (got[0][..., 3] == 255).all()
    _assert_close_frames(got[2], want[2], [(got[1], want[1], 1e-5), (got[0], want[0], 1)])
    # tests/test_raycast_jax.py's bounds against the host renderer
    for k, (rgb_h, depth_h, seg_h) in enumerate(hosts):
        mismatch = seg_h != got[2][k]
        assert mismatch.mean() < 0.01
        np.testing.assert_allclose(got[1][k][~mismatch], depth_h[~mismatch], atol=2e-4)
        diff = np.abs(rgb_h[..., :3].astype(np.int32) - got[0][k, ..., :3].astype(np.int32))
        assert (diff[~mismatch] > 1).mean() < 0.005
    if kind == "empty":
        assert (got[2] <= 0).all()


@pytest.mark.parametrize("mask", [True, False])
def test_raycast_packed_matches_jax(mask):
    be, cam, _, states, scene = _frames("moving")
    obj_ids = np.array([1, 2, 3])
    mbd = 0.97
    want = [np.asarray(x) for x in RaycastJax.from_camera(cam).render_frames_packed(
        states, scene, mbd, obj_ids, mask=mask)]
    got = [x.numpy() for x in RaycastTorch.from_camera(cam, device=CPU).render_frames_packed(
        states, scene, mbd, obj_ids, mask=mask)]
    assert [g.dtype for g in got] == [np.uint8, np.float32, np.uint8, np.uint8]
    assert got[0].shape == (3, 72, 96, 3) and got[1].max() <= np.float32(mbd)
    _assert_close_frames(got[3], want[3], [(got[1], want[1], 1e-5), (got[0], want[0], 1),
                                           (got[2], want[2], 1)])
    # the save_image wrap: -1 -> 1, id k -> (-k) mod 256
    seg = RaycastTorch.from_camera(cam, device=CPU).render_frames(states, scene)[2].numpy()
    if mask:
        seg = np.where(seg != obj_ids[:, None, None], -1, obj_ids[:, None, None])
    np.testing.assert_array_equal(got[3], np.mod(seg * 255, 256).astype(np.uint8))
    assert set(np.unique(got[3])) <= {1, 0, 255, 254, 253}


# --- TactileRendererTorch ---------------------------------------------------------


def test_tactile_renderer_matches_jax_and_host(tactile_scenes):
    _, js, _, ts = tactile_scenes
    _, rgb_clip, depth_clip, _, _ = js.get_sensor_image()
    ts.get_sensor_image()
    host = js.get_tactile_image(rgb_clip, depth_clip,
                                js.get_sensor_pointcloud(rgb_clip, depth_clip))[:, :, :3]
    want = np.asarray(TactileRendererJax.from_sensor(js)(np.asarray(depth_clip)[None]))[0]
    renderer = TactileRendererTorch.from_sensor(ts, device=CPU)
    got = renderer(np.asarray(depth_clip)[None]).numpy()[0]
    assert got.shape == (480, 640, 3) and got.dtype == np.uint8
    gap = np.abs(got.astype(int) - want.astype(int))
    assert (gap <= 1).mean() >= 0.9999, (gap <= 1).mean()
    # tests/test_tactile_jax.py's bounds against the host pipeline
    diff = np.abs(host.astype(int) - got.astype(int))
    assert (diff <= 1).mean() > 0.998
    assert (diff.max(axis=2) > 1).sum() < 2000
    assert TactileRendererTorch.cached_from_sensor(ts, device=CPU) is \
        TactileRendererTorch.cached_from_sensor(ts, device=CPU)


def test_tactile_per_frame_state_matches_jax():
    """``render_frames`` with per-frame camera and light state, the sensor
    moved between two frames (the exp_3 shock), against the JAX renderer and
    the static path."""
    (jb, js), (tb, ts) = _tactile_scene(jphysics, jsensor), _tactile_scene(tphysics, tsensor)
    depths, states = [], []
    for pose in ([0.0, 0.0, 0.5], [0.22, 0.12, 0.55]):
        for b, s in ((jb, js), (tb, ts)):
            b.set_pose(s.sensor_id, pose, [0, 0, 0, 1])
            frame = s.get_sensor_image()
        depths.append(np.asarray(frame[2]))
        states.append(TactileRendererTorch.capture_frame_state(ts))
        for a, b in zip(states[-1], TactileRendererJax.capture_frame_state(js)):
            assert np.array_equal(a, b)
    args = [np.stack(depths)] + [np.stack([s[i] for s in states]) for i in range(3)]
    want = np.asarray(TactileRendererJax.from_sensor(js).render_frames(*args))
    renderer = TactileRendererTorch.from_sensor(ts, device=CPU)
    got = renderer.render_frames(*args).numpy()
    assert got.shape == (2, 480, 640, 3)
    assert (np.abs(got.astype(int) - want.astype(int)) <= 1).mean() >= 0.9999
    assert not np.array_equal(got[0], got[1])
    # the last frame's state is the renderer's own: the static path agrees
    static = renderer(args[0][1:]).numpy()
    assert (np.abs(static.astype(int) - got[1:].astype(int)) <= 1).mean() >= 0.9999
