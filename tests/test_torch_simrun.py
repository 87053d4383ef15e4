"""Port parity: the run-length wire, the simulator's host modules and the
dump helpers of ``mmdyn_tpu_torch/cli/_simrun.py`` against the JAX package
on the CPU.

* ``utils/wire``: the cases of ``tests/test_wire.py`` through both wires on
  the same numpy streams: the payload (``v*``, ``lengths``, ``n_runs``),
  ``run_bounds``, the raw fallback and ``pack_rgb`` / ``unpack_rgb`` equal.
* ``sim/geometry``, ``sample``, ``meshio``, ``assets``, ``config`` and
  ``ros_camera``: bit for bit against their JAX-package originals.
* ``_simrun``: ``make_deferred``'s routing, ``DeferredTactile``'s static and
  moving routes, the writer's errors, and ``DeferredFrames`` against the
  JAX one on the snapshots of a moving sensor at ``tests/test_torch_sim.py``'s
  bounds: seg equal on >= 99.9% of pixels; where seg agrees, visual and
  depth within 1; tactile within 1 on >= 99.99%.
"""

import random
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmdyn_tpu.sim import assets as jassets
from mmdyn_tpu.sim import config as jconfig
from mmdyn_tpu.sim import geometry as jgeometry
from mmdyn_tpu.sim import meshio as jmeshio
from mmdyn_tpu.sim import physics as jphysics
from mmdyn_tpu.sim import ros_camera as jros
from mmdyn_tpu.sim import sample as jsample
from mmdyn_tpu.sim import sensor as jsensor
from mmdyn_tpu.sim.transforms import quat_from_euler
from mmdyn_tpu.utils import wire as jwire

from mmdyn_tpu_torch.sim import assets as tassets
from mmdyn_tpu_torch.sim import config as tconfig
from mmdyn_tpu_torch.sim import geometry as tgeometry
from mmdyn_tpu_torch.sim import meshio as tmeshio
from mmdyn_tpu_torch.sim import physics as tphysics
from mmdyn_tpu_torch.sim import ros_camera as tros
from mmdyn_tpu_torch.sim import sample as tsample
from mmdyn_tpu_torch.sim import sensor as tsensor
from mmdyn_tpu_torch.sim.tactile_torch import TactileRendererTorch
from mmdyn_tpu_torch.utils import wire as twire

CPU = "cpu"
REPO = Path(__file__).resolve().parents[1]
MESHES = [REPO / f"graphics/objects/{name}/models/model_normalized.obj"
          for name in ("winebottle", "bowl")]


# --- the run-length wire ---------------------------------------------------------


def _wire_streams(case):
    """(streams, row_len, planes) of the cases of tests/test_wire.py."""
    if case == "structured":
        rng = np.random.default_rng(0)
        f, n = 5, 4096
        x = np.repeat(rng.integers(0, 7, size=(f, n // 64), dtype=np.uint32), 64, axis=1)
        return [x], n, 3
    if case == "boundaries":
        n = 256
        return [np.zeros((3, n), np.uint32), np.full((2, n), 9, np.uint32)], n, 3
    if case == "noise":
        rng = np.random.default_rng(1)
        return [rng.integers(0, 2**24, size=(2, 2048), dtype=np.uint32)], 2048, 3
    rng = np.random.default_rng(3)
    n = 4096
    a = np.repeat(rng.integers(0, 2**32 - 1, size=(4, n // 64), dtype=np.uint32), 64, axis=1)
    return [a, np.full((2, n), 7, np.uint32)], n, 4


@pytest.mark.parametrize("case", ["structured", "boundaries", "noise", "four_planes"])
def test_wire_payload_equals_jax(case):
    """The payload equals the first n_runs entries of the JAX ``_encode`` on
    the same stream. The JAX wire downloads a bucket of at least 4096 runs
    and falls back to the raw streams when the bucket would outweigh them;
    the port slices n_runs, so only the noise stream falls back in both."""
    streams, row_len, planes = _wire_streams(case)
    jw, tw = jwire.RunLengthWire(), twire.RunLengthWire()
    flat = jnp.concatenate([jnp.asarray(s).reshape(-1) for s in streams])
    *parts, n_runs = (np.asarray(a) for a in jwire._encode(flat, row_len, planes))
    th = tw.encode([torch.from_numpy(s.view(np.int32)) for s in streams], row_len=row_len,
                   planes=planes)
    assert int(th["n_runs"]) == int(n_runs)
    got = tw.get_raw(th)
    assert ("fallback" in got) == (case == "noise")
    want = jw.get_raw(jw.encode([jnp.asarray(s) for s in streams], row_len=row_len,
                                planes=planes))
    if case == "noise":
        assert "fallback" in want
    else:
        want_payload = {f"v{p}": parts[p][:int(n_runs)] for p in range(planes)}
        want_payload["lengths"] = parts[-1][:int(n_runs)]
        assert sorted(got) == sorted(list(want_payload) + ["planes", "shapes"])
        for key, w in want_payload.items():
            assert got[key].dtype == w.dtype
            np.testing.assert_array_equal(got[key], w, err_msg=key)
        assert got["shapes"] == [s.shape for s in streams] and got["planes"] == planes
        want_payload["shapes"] = got["shapes"]
        assert twire.RunLengthWire.run_bounds(got) == \
            jwire.RunLengthWire.run_bounds(want_payload)
        if "fallback" not in want:     # the JAX wire's own download, where it has one
            for key, w in want_payload.items():
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for out, back, s in zip(twire.RunLengthWire.decode(got), jwire.RunLengthWire.decode(want),
                            streams):
        assert out.dtype == back.dtype == np.uint32
        np.testing.assert_array_equal(out, s)
        np.testing.assert_array_equal(back, s)
    if case == "boundaries":
        assert int(th["n_runs"]) == 5          # one run per frame


def test_wire_pack_unpack_rgb_equal_jax():
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, size=(3, 8, 16, 3), dtype=np.uint8)
    got = twire.pack_rgb(torch.from_numpy(img))
    want = np.asarray(jwire.pack_rgb(jnp.asarray(img)))
    assert got.shape == (3, 8 * 16) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(twire.unpack_rgb(got.numpy(), 8, 16), img)
    np.testing.assert_array_equal(twire.unpack_rgb(want, 8, 16), jwire.unpack_rgb(want, 8, 16))


def test_wire_refuses_what_it_cannot_encode():
    w = twire.RunLengthWire()
    x = torch.zeros(2, 64, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        w.encode([x.to(torch.int64)], row_len=64)
    with pytest.raises(ValueError, match="2\\^16"):
        w.encode([x], row_len=65536)
    with pytest.raises(ValueError, match="multiple"):
        w.encode([x], row_len=48)


# --- host modules, bit for bit ---------------------------------------------------------


def _flat(x):
    """A comparable form of a pose, a list of poses or an array."""
    if isinstance(x, (list, tuple)):
        return [_flat(v) for v in x]
    if hasattr(x, "pose"):
        return (x.header.frame_id, jgeometry.pose_stamped2list(x))
    return np.asarray(x).tolist()


GEOMETRY_CASES = {
    "pose_matrix_roundtrip": lambda g: g.pose_from_matrix(g.matrix_from_pose(
        g.list2pose_stamped([0.1, -0.2, 0.3, 0.0, 0.0, 0.7071068, 0.7071068]))),
    "transform_body": lambda g: g.transform_body(
        g.list2pose_stamped([1, 2, 3, 0.1, 0.2, 0.3, 0.9273618]),
        g.pose_from_matrix(np.diag([1.0, -1.0, -1.0, 1.0]), frame_id="body")),
    "interpolate_pose": lambda g: g.interpolate_pose(
        g.list2pose_stamped([0, 0, 0, 0, 0, 0, 1]),
        g.list2pose_stamped([1, 0, 0, 0, 0, 0.7071068, 0.7071068]), N=5),
    "offset_local_pose": lambda g: g.offset_local_pose(
        g.list2pose_stamped([0, 0, 0] + list(quat_from_euler([0, 0, np.pi / 2]))), [1.0, 0, 0]),
    "rotate_local_pose": lambda g: g.rotate_local_pose(
        g.list2pose_stamped([0.3, 0, 0, 0, 0, 0, 1]), [0, 0, np.pi / 2]),
    "get_2d_pose": lambda g: g.get_2d_pose(
        g.list2pose_stamped([1, 2, 0] + list(quat_from_euler([0, 0, 0.7])))),
    "unwrap": lambda g: g.unwrap([3.5 * np.pi / 2 + np.pi, -4.0]),
    "convert_reference_frame_list": lambda g: g.convert_reference_frame_list(
        [g.list2pose_stamped([i, 0, 0, 0, 0, 0, 1]) for i in range(3)],
        g.list2pose_stamped([0.5, 0, 1, 0, 0, 0.3826834, 0.9238795]), g.unit_pose()),
    "C3": lambda g: [g.C3(0.4), g.C3_2d(0.4)],
}


@pytest.mark.parametrize("case", sorted(GEOMETRY_CASES))
def test_geometry_equals_jax(case):
    """The cases of tests/test_sim_core.py's geometry classes."""
    fn = GEOMETRY_CASES[case]
    assert _flat(fn(tgeometry)) == _flat(fn(jgeometry))


@pytest.mark.parametrize("kwargs", [
    {}, {"random_orn": True, "random_chance": 0.8, "gaussian_std": 0.05},
    {"random_orn": True, "random_chance": 0.0}, {"random_yaw": True}])
def test_sample_pose_draws_as_jax(kwargs):
    """Equal seeds give equal poses, and the global ``random`` and
    ``np.random`` streams are left in the same state (the CLIs' per-trial
    seeds rely on the order of the draws)."""
    out = {}
    for name, mod in (("jax", jsample), ("port", tsample)):
        random.seed(11)
        np.random.seed(11)
        poses = [mod.sample_pose([0.0, 0.0, 1.5], **kwargs) for _ in range(4)]
        poses.append(mod.sample_positions([1, 2, 3], 3, gaussian_std=0.2))
        out[name] = (_flat(poses), random.random(), np.random.random())
    assert out["port"] == out["jax"]


def test_sample_point_on_mesh_equals_jax(monkeypatch):
    """sample_point_on_mesh on the bundled bowl, ``Mesh.sample_surface``'s
    unseeded default_rng() pinned to one seed for both."""
    default_rng = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng", lambda seed=None: default_rng(5))
    got = tsample.sample_point_on_mesh(tmeshio.load_obj(MESHES[1]), base_position=(1, 2, 3),
                                       base_orientation=(0, 0, 0.3826834, 0.9238795), scale=2)
    want = jsample.sample_point_on_mesh(jmeshio.load_obj(MESHES[1]), base_position=(1, 2, 3),
                                        base_orientation=(0, 0, 0.3826834, 0.9238795), scale=2)
    assert _flat(got) == _flat(want)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda p: p.parts[-3])
def test_meshio_equals_jax(mesh):
    got, want = tmeshio.load_obj(mesh), jmeshio.load_obj(mesh)
    for attr in ("vertices", "faces", "centroid", "extents", "bounds"):
        np.testing.assert_array_equal(getattr(got, attr), getattr(want, attr), err_msg=attr)
    np.testing.assert_array_equal(got.face_normals(), want.face_normals())
    np.testing.assert_array_equal(got.face_areas(), want.face_areas())
    for a, b in zip(got.sample_surface(16, rng=np.random.default_rng(4)),
                    want.sample_surface(16, rng=np.random.default_rng(4))):
        np.testing.assert_array_equal(a, b)
    assert _flat(tmeshio.obj_bounds(mesh)) == _flat(jmeshio.obj_bounds(mesh))
    mtl = mesh.with_suffix(".mtl")
    assert {k: vars(v) for k, v in tmeshio.parse_mtl(mtl).items()} == \
        {k: vars(v) for k, v in jmeshio.parse_mtl(mtl).items()}


def test_assets_and_config_equal_jax(tmp_path, monkeypatch):
    for key in ("TIME_STEP", "RENDERS", "SHAPENET_DATASETS", "SHAPENET_CORE", "OBJECTS",
                "DEFAULT_WEIGHT", "DEFAULT_UNIT", "DEFAULT_UP", "DEFAULT_FRONT",
                "COM_THRESHOLD", "SHAPENET_SEM"):
        assert getattr(tconfig, key) == getattr(jconfig, key), key
    for n, seed in ((8, 0), (5, 1)):
        got = tassets.synthetic_object_catalog(n, seed=seed)
        want = jassets.synthetic_object_catalog(n, seed=seed)
        assert _flat([list(r.items()) for r in got]) == _flat([list(r.items()) for r in want])
    # graphics_root falls back to the repo's bundled meshes from any cwd
    monkeypatch.delenv("MMDYN_GRAPHICS_ROOT", raising=False)
    monkeypatch.chdir(tmp_path)
    for name, n in (("winebottle", 1), ("bowl", 1), ("winebottle", 3)):
        got, want = tassets.preload_object(name, n_objects=n), jassets.preload_object(name, n)
        assert _flat(list(got.items())) == _flat(list(want.items()))
        assert Path(got["obj"] if n == 1 else got["obj"][0]).is_file()
    with pytest.raises(AssertionError):
        tassets.preload_object("spoon")


def test_spawn_object_on_the_analytic_engine_equals_jax():
    bodies = []
    for a, p in ((tassets, tphysics), (jassets, jphysics)):
        backend = p.AnalyticBackend()
        for info in a.synthetic_object_catalog(4, seed=3):
            a.spawn_object(backend, info, position=[0.1, 0.0, 1.2], orientation=[0, 0, 0, 1],
                           mass=1, color=info["colors"][0])
        bodies.append({bid: (b.shape, np.asarray(b.size).tolist(), b.position.tolist(),
                             b.orientation.tolist(), list(b.color), b.mass)
                       for bid, b in backend.bodies.items()})
    assert bodies[0] == bodies[1]


# the calibration fixtures of tests/test_sim_extras.py
LEFT = dict(
    k=[430.15433, 0.0, 311.71339, 0.0, 430.60921, 221.06824, 0.0, 0.0, 1.0],
    d=[-0.363528858080088, 0.16117037733986861, -8.1109585007538829e-05,
       -0.00044776712298447841, 0.0],
    r=[0.99975321, 0.00505219, 0.02162504, -0.00509732, 0.99998565, 0.00203206,
       -0.02161446, -0.00214189, 0.9997641],
    p=[295.53402, 0.0, 285.55805, 0.0, 0.0, 295.53402, 223.29201, 0.0, 0.0, 0.0, 1.0, 0.0],
    width=640, height=480)
RIGHT = dict(
    k=[412.04678, 0.0, 313.96596, 0.0, 412.5877, 230.39125, 0.0, 0.0, 1.0],
    d=[-0.3560641041112021, 0.15647260261553159, -0.00016442960757099968,
       -0.00093175810713916221, 0.0],
    r=[0.9999244, 0.00192052, 0.01214498, -0.00189529, 0.99999607, -0.00208892,
       -0.01214895, 0.00206575, 0.99992407],
    p=[295.53402, 0.0, 285.55805, -26.21002, 0.0, 295.53402, 223.29201, 0.0, 0.0, 0.0, 1.0,
       0.0],
    width=640, height=480)


def _ros_readings(mod):
    pin = mod.ROSPinholeCameraModel()
    pin.from_camera_params(**LEFT, binning_x=2, roi=mod.ROI(320, 240, 8, 4))
    uv = pin.project_3D_to_pixel([0.1, 0.2, 1.5])
    out = [uv, pin.project_pixel_to_3DRay(uv), pin.get_delta_u(0.5, 2.0),
           pin.get_delta_v(0.25, 2.0), pin.get_delta_x(3.0, 2.0), pin.get_delta_y(3.0, 2.0),
           pin.intrinsic_matrix, pin.projection_matrix, pin.full_intrinsic_matrix,
           pin.rectify_point((320, 240))]
    st = mod.ROSStereoCameraModel()
    st.from_camera_params(LEFT, RIGHT)
    out.append(st.Q)
    for u, v, disparity in ((100, 100, 5.0), (320, 240, 12.5), (500, 400, 40.0)):
        xyz = st.project_pixel_to_3D((u, v), disparity)
        out += [xyz, st.project_3D_to_pixel(xyz)]
    out += [st.get_z(st.get_disparity(1.7)), st.get_z(0), st.get_disparity(0)]
    return out


def test_ros_camera_equals_jax():
    assert _flat(_ros_readings(tros)) == _flat(_ros_readings(jros))


# --- _simrun ------------------------------------------------------------------------


def _tactile_scene(physics, sensor_mod):
    """tests/test_tactile_jax.py's scene: a sphere resting on the sensor."""
    backend = physics.AnalyticBackend()
    sensor = sensor_mod.make_sensor(backend, size=[1.5, 1.5, 1.0], position=[0, 0, 0.5],
                                    sensor_vector=[0, 0, 1], thickness=0.05)
    backend.add_sphere(0.15, [0.05, -0.1, 1.4], mass=0.5)
    for _ in range(400):
        backend.step()
    return backend, sensor


def test_make_deferred_routing(monkeypatch):
    from mmdyn_tpu_torch.cli._simrun import DeferredFrames, DeferredTactile, make_deferred

    _, sensor = _tactile_scene(tphysics, tsensor)
    d = make_deferred(sensor, device=CPU)
    assert isinstance(d, DeferredFrames) and d.device == torch.device(CPU)
    sensor2 = tsensor.make_sensor(tphysics.AnalyticBackend(), size=[1.5, 1.5, 1.0],
                                  position=[0, 0, 0.5], sensor_vector=[0, 0, 1],
                                  thickness=0.05, use_force=True)
    assert isinstance(make_deferred(sensor2, device=CPU), DeferredTactile)
    # no device named: the card, and without one a raise
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for s in (sensor, sensor2):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_deferred(s)


def test_deferred_tactile_routes_static_vs_moving(tmp_path, monkeypatch):
    """A static sensor's frames take the renderer's baked matrices; one that
    moved mid-rollout takes the per-frame ones (exp_3), as the JAX test
    spies them (tests/test_tactile_jax.py)."""
    from mmdyn_tpu_torch.cli._simrun import DeferredTactile

    calls = {"static": 0, "dynamic": 0}
    orig_call, orig_frames = TactileRendererTorch.__call__, TactileRendererTorch.render_frames

    def spy_call(self, depths):
        calls["static"] += 1
        return orig_call(self, depths)

    def spy_frames(self, *a):
        calls["dynamic"] += 1
        return orig_frames(self, *a)

    monkeypatch.setattr(TactileRendererTorch, "__call__", spy_call)
    monkeypatch.setattr(TactileRendererTorch, "render_frames", spy_frames)

    backend, sensor = _tactile_scene(tphysics, tsensor)
    _, _, depth, _, _ = sensor.get_sensor_image()
    d = DeferredTactile(device=CPU)
    d.add(sensor, depth, tmp_path, 0)
    d.add(sensor, depth, tmp_path, 1)
    assert d.flush() == 2
    assert calls == {"static": 1, "dynamic": 0}
    assert (tmp_path / "tactile_0000.png").exists()

    d2 = DeferredTactile(device=CPU)
    d2.add(sensor, depth, tmp_path, 2)
    backend.set_pose(sensor.sensor_id, [0.3, 0.1, 0.5], [0, 0, 0, 1])
    _, _, depth2, _, _ = sensor.get_sensor_image()    # updates the camera
    d2.add(sensor, depth2, tmp_path, 3)
    d2.flush()
    assert calls["dynamic"] == 1
    assert (tmp_path / "tactile_0003.png").exists()


def _read(path):
    import cv2
    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    assert img is not None, path
    return img.astype(np.int64)


def assert_frames_close(got_dir, want_dir, counters):
    """The four PNGs of each counter in ``got_dir`` against ``want_dir`` at
    tests/test_torch_sim.py's bounds."""
    for c in counters:
        seg_got, seg_want = (_read(d / f"seg_{c:04d}.png") for d in (got_dir, want_dir))
        agree = seg_got == seg_want
        assert agree.mean() >= 0.999, (got_dir, c, agree.mean())
        for stem in ("visual", "depth"):
            gap = np.abs(_read(got_dir / f"{stem}_{c:04d}.png")
                         - _read(want_dir / f"{stem}_{c:04d}.png"))
            gap = gap if gap.ndim == 2 else gap.max(axis=-1)
            assert gap[agree].max(initial=0) <= 1, (got_dir, stem, c)
        gap = np.abs(_read(got_dir / f"tactile_{c:04d}.png")
                     - _read(want_dir / f"tactile_{c:04d}.png"))
        assert (gap <= 1).mean() >= 0.9999, (got_dir, c, (gap <= 1).mean())


def test_deferred_frames_moving_sensor_equals_jax(tmp_path):
    """The port's DeferredFrames against the JAX one on the same snapshots of
    a sensor that moves between them (the exp_3 shock): every frame renders
    from its own captured camera state."""
    from mmdyn_tpu.cli._simrun import DeferredFrames as JaxFrames
    from mmdyn_tpu_torch.cli._simrun import DeferredFrames

    poses = [([0.0, 0.0, 0.5], [0, 0, 0, 1]), ([0.22, 0.12, 0.55], [0, 0, 0, 1]),
             ([0.22, 0.12, 0.55], [0, 0, 0, 1])]
    for name, physics, sensor_mod, deferred in (
            ("jax", jphysics, jsensor, JaxFrames()),
            ("port", tphysics, tsensor, DeferredFrames(chunk=2, device=CPU))):
        backend, sensor = _tactile_scene(physics, sensor_mod)
        obj_id = backend.last_body_id()
        for i, (p, q) in enumerate(poses):
            backend.set_pose(sensor.sensor_id, p, q)
            deferred.add_snapshot(sensor, obj_id, tmp_path / name, i)
        assert len(deferred) == 3 and deferred.flush() == 3 and len(deferred) == 0
    assert_frames_close(tmp_path / "port", tmp_path / "jax", range(3))
    # the displacement changed the rendering (the per-frame path ran)
    assert not np.array_equal(_read(tmp_path / "port/tactile_0000.png"),
                              _read(tmp_path / "port/tactile_0001.png"))


def test_deferred_frames_raise_a_writer_error_on_flush(tmp_path, monkeypatch):
    """A PNG writer's exception is raised by flush, not lost in its thread,
    and the writer thread ends."""
    import cv2

    from mmdyn_tpu_torch.cli._simrun import DeferredFrames

    backend, sensor = _tactile_scene(tphysics, tsensor)
    d = DeferredFrames(chunk=1, device=CPU)
    for i in range(3):
        d.add_snapshot(sensor, backend.last_body_id(), tmp_path, i)

    def fail(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(cv2, "imwrite", fail)
    with pytest.raises(OSError, match="disk full"):
        d.flush()
    assert d._writer is None
