"""Shared helpers of the simulator's data-collection CLIs (port of
``mmdyn_tpu/cli/_simrun.py``).

The host path renders and shades every snapshot on the host
(``snapshot``). ``--device-render`` defers the work to a device
(``DeferredTactile``, ``DeferredFrames``) and ``--device-physics`` steps all
of an object's trials there in one batched rollout
(``run_trials_device_physics``). Every device helper takes a ``device``:
``None`` means the card and raises without one.
"""

from __future__ import annotations

import os
import queue
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from mmdyn_tpu_torch.utils.device import resolve_device
from mmdyn_tpu_torch.utils.wire import RunLengthWire, pack_rgb, unpack_rgb


def _trace_on():
    return os.environ.get("MMDYN_GEN_TRACE", "") not in ("", "0")


class _StageClock:
    """Opt-in (``MMDYN_GEN_TRACE=1``) wall-clock attribution of the
    generation pipeline; one stderr line per flush or rollout."""

    def __init__(self):
        self.t = time.perf_counter()
        self.stages = {}

    def mark(self, name):
        now = time.perf_counter()
        self.stages[name] = self.stages.get(name, 0.0) + (now - self.t)
        self.t = now

    def report(self, label):
        total = sum(self.stages.values())
        parts = " ".join(f"{k}={v:.2f}s" for k, v in self.stages.items())
        print(f"# gen-trace {label}: total={total:.2f}s {parts}", file=sys.stderr)


def _baked_state(renderer):
    """The tactile renderer's baked (m_inv, eye, light_dirs), in the layout
    of ``TactileRendererTorch.capture_frame_state``."""
    return renderer._m_inv, renderer._eye, renderer._light_dirs


class DeferredTactile:
    """Batched tactile shading on a device (``--device-render`` where the
    frames themselves stay on the host: a sensor with an equilibrium buffer).

    ``add`` stores the clipped depth buffer and the frame's camera and light
    state; ``flush`` renders every tactile image in chunks on the device
    (``sim/tactile_torch.py``) and writes the PNGs. Per-frame view matrices
    are captured, so a sensor that moves mid-rollout (the exp_3 shock)
    renders right.
    """

    def __init__(self, chunk=128, device=None):
        self.chunk = int(chunk)
        self.device = resolve_device(device)
        self._frames = []        # (depth, m_inv, eye, dirs, path, counter)
        self._renderer = None
        self._camera = None

    def add(self, sensor, depth_eq, path, img_counter):
        from mmdyn_tpu_torch.sim.tactile_torch import TactileRendererTorch

        if self._renderer is None:
            self._renderer = TactileRendererTorch.cached_from_sensor(sensor, device=self.device)
            self._camera = sensor.camera
        m_inv, eye, dirs = TactileRendererTorch.capture_frame_state(sensor)
        self._frames.append((np.asarray(depth_eq, np.float32), m_inv, eye, dirs, Path(path),
                             int(img_counter)))

    def __len__(self):
        return len(self._frames)

    def flush(self):
        """Render all pending frames (chunked) and write the tactile PNGs. A
        static sensor (demo, exp_1, exp_2) takes the renderer's baked
        matrices; only a sensor that moved mid-rollout (the exp_3 shock)
        takes the per-frame ones."""
        if not self._frames:
            return 0
        r = self._renderer
        r_m_inv, r_eye, r_dirs = _baked_state(r)
        static = all(np.array_equal(m, r_m_inv) and np.array_equal(e, r_eye)
                     and np.array_equal(d, r_dirs) for _, m, e, d, _, _ in self._frames)
        n = 0
        for i in range(0, len(self._frames), self.chunk):
            group = self._frames[i:i + self.chunk]
            depths = np.stack([g[0] for g in group])
            if static:
                imgs = r(depths)
            else:
                imgs = r.render_frames(depths, *(np.stack([g[k] for g in group])
                                                 for k in (1, 2, 3)))
            for img, (_, _, _, _, path, counter) in zip(imgs.cpu().numpy(), group):
                self._camera.save_image(img, path, title=f"tactile_{counter:04d}")
                n += 1
        self._frames.clear()
        return n


class DeferredFrames:
    """Snapshot rendering wholly on a device (``--device-render`` on the
    analytic engine, and ``--device-physics``).

    ``add_snapshot`` stores only the frame's camera state and body poses;
    ``flush`` renders visual RGB, depth, segmentation and the tactile image
    of the whole rollout in chunks (``sim/raycast_torch.py`` +
    ``sim/tactile_torch.py``), packs them to their PNG payloads on the
    device, ships them through the run-length wire and writes the PNGs on a
    background thread. Replaces the per-interval host block of the
    reference loops (exp_1_flat_plane.py:121-150,
    tact_sim/tactile/sensor.py:342-445) for ``use_force=False`` sensors on
    plane / sphere / box scenes.
    """

    # raycasters keyed by the camera's intrinsics and the device
    _rc_cache = {}

    def __init__(self, chunk=128, device=None):
        self.chunk = int(chunk)
        self.device = resolve_device(device)
        self._frames = []   # dicts per snapshot
        self._sensor = None
        self._tac = None
        self._rc = None
        self._wire = RunLengthWire()
        self._writer = None
        self._werr = None

    def __len__(self):
        return len(self._frames)

    @classmethod
    def raycaster(cls, camera, device):
        from mmdyn_tpu_torch.sim.raycast_torch import RaycastTorch

        key = (camera.width, camera.height, float(camera.near), float(camera.far), str(device))
        if key not in cls._rc_cache:
            cls._rc_cache[key] = RaycastTorch.from_camera(camera, device=device)
        return cls._rc_cache[key]

    def add_snapshot(self, sensor, obj_id, path, img_counter, mask_seg_to_obj=True):
        """Capture the frame state; returns (pose, force) as the host path."""
        from mmdyn_tpu_torch.sim.raycast_torch import RaycastTorch, capture_scene
        from mmdyn_tpu_torch.sim.tactile_torch import TactileRendererTorch

        sensor._update_pose()
        sensor._update_sensor()
        sensor.refresh_contacts()

        if self._sensor is None:
            self._sensor = sensor
            self._tac = TactileRendererTorch.cached_from_sensor(sensor, device=self.device)
            self._rc = self.raycaster(sensor.camera, self.device)

        sig, static, frame = capture_scene(sensor.backend)
        self._frames.append({
            "cam": RaycastTorch.capture_camera_state(sensor.camera),
            "tac": TactileRendererTorch.capture_frame_state(sensor),
            "sig": sig, "static": static, "frame": frame,
            "path": Path(path), "counter": int(img_counter),
            "obj_id": int(obj_id), "mask": bool(mask_seg_to_obj),
        })

        pose = sensor.backend.get_pose(obj_id)
        force = sensor.contacts.total_force(obj_id) if sensor.contacts else 0.0
        return pose, force

    def _dispatch_chunk(self, g, mbd, tac_static):
        """Queue one chunk's device pipeline (raycast -> tactile -> run-length
        encode); returns a token for ``_download_chunk``. Nothing is
        downloaded and nothing waits for the device."""
        r_m_inv, r_eye, r_dirs = tac_static
        stack = lambda key, i: np.stack([f[key][i] for f in g])  # noqa: E731
        cam_states = {"m_inv": stack("cam", 0), "eye": stack("cam", 1),
                      "forward": stack("cam", 2)}
        scene = dict(g[0]["static"])
        for k in ("sph_pos", "box_pos", "box_q"):
            scene[k] = np.stack([f["frame"][k] for f in g])
        rgb, depth_clip, depth_png, seg_png = self._rc.render_frames_packed(
            cam_states, scene, mbd, np.array([f["obj_id"] for f in g]), mask=g[0]["mask"])

        static_cam = all(np.array_equal(f["tac"][0], r_m_inv)
                         and np.array_equal(f["tac"][1], r_eye)
                         and np.array_equal(f["tac"][2], r_dirs) for f in g)
        if static_cam:
            tactile = self._tac(depth_clip)
        else:
            tactile = self._tac.render_frames(depth_clip, stack("tac", 0), stack("tac", 1),
                                              stack("tac", 2))

        # depth rides visual's spare fourth byte and seg tactile's: the
        # encode's cost is per element, so folding halves it for a few
        # percent more runs. Row breaks at the image row keep run lengths
        # in uint16.
        n, h, wd = rgb.shape[:3]
        s0 = pack_rgb(rgb) | (depth_png.to(torch.int32).reshape(n, -1) << 24)
        s1 = pack_rgb(tactile) | (seg_png.to(torch.int32).reshape(n, -1) << 24)
        handle = self._wire.encode([s0, s1], row_len=wd, planes=4)
        return {"g": g, "handle": handle, "h": h, "w": wd}

    def _download_chunk(self, token, clock=None):
        """Download one dispatched chunk's wire payload (no decode)."""
        raw = self._wire.get_raw(token["handle"])
        if clock is not None:
            clock.mark("wire")
        return raw

    def _write_chunk(self, token, raw):
        """Hand the decode (plane-wise run expansion) and the PNG writes to
        the background writer; they overlap the next chunk's device work."""
        g, h, wd = token["g"], token["h"], token["w"]

        def write():
            import cv2

            sh = (len(g), h, wd)
            if "fallback" in raw:
                s0, s1 = RunLengthWire.decode(raw)
                vis = unpack_rgb(s0 & 0xFFFFFF, h, wd)[..., ::-1]    # BGR
                tac = unpack_rgb(s1 & 0xFFFFFF, h, wd)[..., ::-1]
                dep = (s0 >> 24).reshape(sh).astype(np.uint8)
                seg = (s1 >> 24).reshape(sh).astype(np.uint8)
                planes = None
            else:
                # expand the byte planes directly: stream 0 = visual rgb +
                # depth in byte 3, stream 1 = tactile rgb + seg in byte 3
                (a0, b0), (a1, b1) = RunLengthWire.run_bounds(raw)
                le = raw["lengths"]
                rep = lambda v, a, b: np.repeat(v[a:b], le[a:b]).reshape(sh)  # noqa: E731
                planes = {
                    "vis": [rep(raw[k], a0, b0) for k in ("v2", "v1", "v0")],
                    "tac": [rep(raw[k], a1, b1) for k in ("v2", "v1", "v0")],
                }
                dep = rep(raw["v3"], a0, b0)
                seg = rep(raw["v3"], a1, b1)
            for j, f in enumerate(g):
                f["path"].mkdir(parents=True, exist_ok=True)
                c = f["counter"]
                if planes is None:
                    vj = np.ascontiguousarray(vis[j])
                    tj = np.ascontiguousarray(tac[j])
                else:
                    # merge is BGR order (v2 = b, v1 = g, v0 = r)
                    vj = cv2.merge([p[j] for p in planes["vis"]])
                    tj = cv2.merge([p[j] for p in planes["tac"]])
                cv2.imwrite(str(f["path"] / f"visual_{c:04d}.png"), vj)
                cv2.imwrite(str(f["path"] / f"tactile_{c:04d}.png"), tj)
                cv2.imwrite(str(f["path"] / f"seg_{c:04d}.png"), seg[j])
                cv2.imwrite(str(f["path"] / f"depth_{c:04d}.png"), dep[j])

        self._submit_write(write)
        return len(g)

    def _submit_write(self, fn):
        """One background writer, at most one queued job (bounds host
        memory). A job's exception is kept and raised by ``_join_writes``."""
        if self._writer is None:
            self._wq = queue.Queue(maxsize=1)

            def loop():
                while True:
                    job = self._wq.get()
                    try:
                        if job is None:
                            return
                        job()
                    except Exception as e:   # raised on join
                        if self._werr is None:
                            self._werr = e
                    finally:
                        self._wq.task_done()

            self._werr = None
            self._writer = threading.Thread(target=loop, name="png-writer", daemon=True)
            self._writer.start()
        self._wq.put(fn)

    def _join_writes(self):
        """Stop the writer after its queued jobs; raise the first job's
        exception, if any."""
        if self._writer is None:
            return
        self._wq.put(None)
        self._writer.join()
        self._writer = None
        if self._werr is not None:
            err, self._werr = self._werr, None
            raise err

    def flush(self):
        """Render and write every queued snapshot's four PNGs.

        Every payload is packed to its final uint8 form on the device
        (``render_frames_packed`` + the run-length wire). Chunks run as a
        one-deep pipeline: chunk k is downloaded before chunk k+1 is
        dispatched, and chunk k's decode and PNG writes run in the
        background writer while the device works on chunk k+1.
        """
        if not self._frames:
            return 0
        n = 0
        # consecutive snapshots of one (signature, mask) share a chunk
        key = lambda f: (f["sig"], f["mask"])  # noqa: E731
        groups, cur = [], [self._frames[0]]
        for f in self._frames[1:]:
            if key(f) == key(cur[0]):
                cur.append(f)
            else:
                groups.append(cur)
                cur = [f]
        groups.append(cur)

        mbd = float(self._sensor.max_buffer_depth)
        tac_static = _baked_state(self._tac)
        clock = _StageClock() if _trace_on() else None
        chunks = [group[i:i + self.chunk] for group in groups
                  for i in range(0, len(group), self.chunk)]
        try:
            token = self._dispatch_chunk(chunks[0], mbd, tac_static)
            for nxt in chunks[1:]:
                raw = self._download_chunk(token, clock)
                token_next = self._dispatch_chunk(nxt, mbd, tac_static)
                if clock is not None:
                    clock.mark("dispatch")
                n += self._write_chunk(token, raw)
                token = token_next
            raw = self._download_chunk(token, clock)
            n += self._write_chunk(token, raw)
        finally:
            self._join_writes()
        if clock is not None:
            clock.mark("png-join")
            clock.report(f"flush[{n} frames]")
        self._frames.clear()
        return n


def run_trials_device_physics(backend, sensor, obj_id, trial_states, n_timesteps, interval,
                              paths, snapshot_from=0, ext_forces=None, mask_seg_to_obj=True,
                              blank_guard=True, device=None):
    """Run K independent trials of one analytic scene on a device.

    Replaces the host stepping loop of the experiment CLIs
    (exp_1_flat_plane.py:136-145 and the others): the stepping runs as one
    batched rollout over all K trials (``sim/physics_torch.py::
    SimulatorTorch``), the snapshots render through ``DeferredFrames``, and
    only poses, forces and the finished PNG payloads cross to the host.

    Args:
        trial_states: per trial, a dict {body_id: (position, orientation)}
            of pose overrides applied before the rollout (set_pose
            semantics: the velocity is zero).
        ext_forces: optional (K, T, NB, 3) world-frame forces in body-row
            order (rows = ascending body id), pybullet applyExternalForce
            one-step semantics.
        blank_guard: the experiments' first-frame check: a trial whose
            initial raw segmentation is empty is skipped (None for it),
            exp_1_flat_plane.py:124-129.
        device: where the rollout and the frames run (None: the card).

    Returns a list of per-trial dicts (or None for skipped trials) with keys
    time_step / time / position / orientation / force, where force is the
    sensor <-> object total normal force at each snapshot (the
    Contact.total_force semantics, sim/contact.py).
    """
    from mmdyn_tpu_torch.sim import config as sim_config
    from mmdyn_tpu_torch.sim.physics_torch import pack_scene
    from mmdyn_tpu_torch.sim.raycast_torch import RaycastTorch, capture_scene

    device = resolve_device(device)
    k_trials = len(trial_states)
    clock = _StageClock() if _trace_on() else None
    sim, ids, consts = pack_scene(backend, device=device)
    row = {bid: r for r, bid in enumerate(ids)}

    pos = np.tile(consts["pos"][None], (k_trials, 1, 1))
    quat = np.tile(consts["quat"][None], (k_trials, 1, 1))
    for k, overrides in enumerate(trial_states):
        for bid, (p, q) in overrides.items():
            pos[k, row[bid]] = np.asarray(p, np.float64)
            quat[k, row[bid]] = np.asarray(q, np.float64)
    vel = np.zeros_like(pos)
    sizes = np.tile(consts["sizes"][None], (k_trials, 1, 1))
    mass = np.tile(consts["mass"][None], (k_trials, 1))

    # --- blank guard: the initial raw seg, its blankness reduced on the device
    sensor._update_pose()
    sensor._update_sensor()
    _, static, _ = capture_scene(backend)
    sph_rows = [row[int(i)] for i in static["sph_id"]]
    box_rows = [row[int(i)] for i in static["box_id"]]

    skip = [False] * k_trials
    if blank_guard:
        cam = sensor.camera
        rc = DeferredFrames.raycaster(cam, device)
        cam_state = RaycastTorch.capture_camera_state(cam)
        cam_states = {key: np.stack([v] * k_trials)
                      for key, v in zip(("m_inv", "eye", "forward"), cam_state)}
        scene = dict(static, sph_pos=pos[:, sph_rows].astype(np.float32),
                     box_pos=pos[:, box_rows].astype(np.float32),
                     box_q=quat[:, box_rows].astype(np.float32))
        _, _, seg0 = rc.render_frames(cam_states, scene)
        skip = (seg0 == -1).all(dim=2).all(dim=1).tolist()

    if clock is not None:
        clock.mark("blank-guard")
    # --- the whole rollout batch in one call
    out = sim.simulate(pos, vel, quat, sizes, mass, int(n_timesteps), ext_forces=ext_forces)
    traj = out["pos"].cpu().numpy()
    cf = out["contact_force"].cpu().numpy()
    if clock is not None:
        clock.mark("simulate")

    # the sensor <-> object pair force (Contact.total_force drops the ground)
    force_series = np.zeros((k_trials, int(n_timesteps)), np.float64)
    sensor_row, obj_row = row[sensor.sensor_id], row[obj_id]
    if backend.bodies[sensor.sensor_id].shape == "box":
        force_series += cf[:, :, obj_row, sim.support_slot(sensor_row)]
    if backend.bodies[obj_id].shape == "box":
        force_series += cf[:, :, sensor_row, sim.support_slot(obj_row)]

    snap_ts = [t for t in range(int(n_timesteps))
               if (t + 1) % int(interval) == 0 and t >= int(snapshot_from)]

    deferred = DeferredFrames(device=device)
    results = []
    for k in range(k_trials):
        if skip[k]:
            results.append(None)
            continue
        data = {"time_step": [], "time": [], "position": [], "orientation": [], "force": []}
        # immovable bodies keep their per-trial override for the whole
        # rollout (exp_2's inclined fixed sensor)
        for bid, (p, q) in trial_states[k].items():
            if not sim.movable[row[bid]]:
                backend.set_pose(bid, p, q)
        for c, t in enumerate(snap_ts):
            # replay the simulated state into the host backend, so the
            # capture (the camera follows a movable sensor, the scene
            # snapshot) sees the step-t world
            for bid in ids:
                r = row[bid]
                if sim.movable[r]:
                    backend.set_pose(bid, traj[k, t, r], quat[k, r])
            deferred.add_snapshot(sensor, obj_id, paths[k], c, mask_seg_to_obj=mask_seg_to_obj)
            p, q = backend.get_pose(obj_id)
            data["time_step"].append(t)
            data["time"].append(t * getattr(backend, "time_step", sim_config.TIME_STEP))
            data["position"].append([float(x) for x in p])
            data["orientation"].append([float(x) for x in q])
            # a snapshot at iteration t reads the contacts of step t-1 (the
            # loops snapshot before backend.step())
            data["force"].append(float(force_series[k, t - 1]) if t > 0 else 0.0)
        results.append(data)
    if clock is not None:
        clock.mark("capture")
        clock.report(f"rollout[{k_trials} trials x {n_timesteps} steps]")
    deferred.flush()
    return results


def make_deferred(sensor, device=None):
    """The deepest device-side deferral this sensor and backend support:
    whole frames on the analytic engine (no equilibrium buffer), tactile
    shading only otherwise."""
    from mmdyn_tpu_torch.sim.physics import AnalyticBackend

    if isinstance(sensor.backend, AnalyticBackend) and not getattr(sensor, "_use_force", False):
        return DeferredFrames(device=device)
    return DeferredTactile(device=device)


def snapshot(sensor, obj_id, path, img_counter, mask_seg_to_obj=True, debug=False,
             show_image=False, deferred=None):
    """One sensing snapshot: render, tactile-shade, dump the PNGs.

    Mirrors the per-interval block of the reference experiment loops
    (exp_1_flat_plane.py:121-150). Returns (pose, contact_force). With
    ``deferred`` a DeferredTactile, the host Phong shading is skipped and the
    frame's depth and camera state are queued for the device; a
    DeferredFrames defers the raycast too (nothing renders on the host, and
    ``show_image`` is unavailable).
    """
    if isinstance(deferred, DeferredFrames):
        return deferred.add_snapshot(sensor, obj_id, path, img_counter,
                                     mask_seg_to_obj=mask_seg_to_obj)
    rgb_img, rgb_eq, depth_eq, seg_img, seg_eq = sensor.get_sensor_image()
    seg_img = np.asarray(seg_img)
    if mask_seg_to_obj:
        seg_img = np.where(seg_img != obj_id, -1, obj_id)

    if deferred is not None:
        deferred.add(sensor, depth_eq, path, img_counter)
        tactile_img = None
    else:
        pointcloud = sensor.get_sensor_pointcloud(rgb_eq, depth_eq, mask=False)
        tactile_img = sensor.get_tactile_image(rgb_eq, depth_eq, pointcloud)

    pose = sensor.backend.get_pose(obj_id)
    force = sensor.contacts.total_force(obj_id) if sensor.contacts else 0.0

    path = Path(path)
    cam = sensor.camera
    cam.save_image(rgb_img, path, title=f"visual_{img_counter:04d}")
    if tactile_img is not None:
        cam.save_image(tactile_img, path, title=f"tactile_{img_counter:04d}")
    cam.save_image(seg_img, path, RGB=False, title=f"seg_{img_counter:04d}")
    cam.save_image(depth_eq, path, RGB=False, title=f"depth_{img_counter:04d}")

    if show_image:
        cam.show_image(rgb_img, title="Raw RGB", save=False)
        if tactile_img is not None:
            cam.show_image(tactile_img, title="Tactile RGB", save=False)
    return pose, force
