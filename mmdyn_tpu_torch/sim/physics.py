"""Physics / render backends (the port's copy of ``mmdyn_tpu/sim/physics.py``).

``PhysicsBackend`` is the seam between the sensor stack and the engine:

* ``PyBulletBackend`` — wraps Bullet (rigid bodies, meshes, OpenGL render);
  imported lazily so environments without pybullet can still use everything
  else.
* ``AnalyticBackend`` — a self-contained rigid-body + raycast engine
  (numpy-vectorised): spheres and oriented boxes under gravity, impulse
  contact with the ground plane / fixed bodies, per-pixel analytic ray
  intersection for RGB/depth/seg rendering. It exists so the full
  data-generation pipeline (demo + experiments -> PNG dumps -> compile ->
  train) runs end-to-end in environments without Bullet, and doubles as a
  deterministic test double.

Conventions match PyBullet where they show at the sensor API: seg images are
int arrays with -1 for background and 0 for the ground plane; depth images are
normalised buffers z_b in [0, 1].
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from mmdyn_tpu_torch.sim import config
from mmdyn_tpu_torch.sim.transforms import quat_to_matrix


@dataclasses.dataclass
class Contact:
    body_a: int
    body_b: int
    position: Tuple[float, float, float]
    normal_force: float


@dataclasses.dataclass
class _Body:
    shape: str                      # 'sphere' | 'box' | 'plane'
    size: np.ndarray                # radius (1,) or half-extents (3,)
    position: np.ndarray
    orientation: np.ndarray         # xyzw
    velocity: np.ndarray
    mass: float
    color: np.ndarray               # rgb in [0, 1]
    fixed: bool


class PhysicsBackend:
    """Interface; see module docstring."""

    def step(self):
        raise NotImplementedError

    def render(self, camera):
        raise NotImplementedError

    def get_pose(self, body_id):
        raise NotImplementedError

    def set_pose(self, body_id, position, orientation):
        raise NotImplementedError

    def contacts(self, body_id) -> List[Contact]:
        raise NotImplementedError

    def remove_body(self, body_id):
        raise NotImplementedError

    def num_bodies(self) -> int:
        raise NotImplementedError

    def reset(self):
        raise NotImplementedError

    def disconnect(self):
        pass


class AnalyticBackend(PhysicsBackend):
    """Small rigid-body + raycast engine (see module docstring)."""

    GROUND_ID = 0

    def __init__(self, time_step=config.TIME_STEP, gravity=(0, 0, -10),
                 load_plane=True, restitution=0.1, damping=0.98,
                 render_dtype=np.float32):
        """``render_dtype`` controls raycast precision: float32 (default) is
        faster with sub-pixel differences; float64 reproduces the renders of
        the float64 engine bit-exactly."""
        self.render_dtype = np.dtype(render_dtype)
        self.time_step = time_step
        self.gravity = np.asarray(gravity, dtype=np.float64)
        self.restitution = restitution
        self.damping = damping
        self.bodies: Dict[int, _Body] = {}
        self._next_id = 0
        self._contacts: List[Contact] = []
        self._ext_forces: Dict[int, np.ndarray] = {}
        self.time = 0.0
        if load_plane:
            # ground plane z=0, body id 0 (like plane100.urdf at id 0)
            self._add(_Body("plane", np.zeros(1), np.zeros(3),
                            np.array([0, 0, 0, 1.0]), np.zeros(3), 0.0,
                            np.array([0.85, 0.85, 0.85]), True))

    # --- body management --------------------------------------------------

    def _add(self, body: _Body) -> int:
        bid = self._next_id
        self.bodies[bid] = body
        self._next_id += 1
        return bid

    def add_sphere(self, radius, position, mass=1.0, color=(1, 0, 0),
                   fixed=False):
        return self._add(_Body("sphere", np.array([radius], np.float64),
                               np.asarray(position, np.float64),
                               np.array([0, 0, 0, 1.0]),
                               np.zeros(3), mass,
                               np.asarray(color[:3], np.float64), fixed))

    def add_box(self, half_extents, position, orientation=(0, 0, 0, 1),
                mass=1.0, color=(1, 0, 0), fixed=False):
        return self._add(_Body("box", np.asarray(half_extents, np.float64),
                               np.asarray(position, np.float64),
                               np.asarray(orientation, np.float64),
                               np.zeros(3), mass,
                               np.asarray(color[:3], np.float64), fixed))

    def get_pose(self, body_id):
        b = self.bodies[body_id]
        return tuple(b.position), tuple(b.orientation)

    def set_pose(self, body_id, position, orientation):
        b = self.bodies[body_id]
        b.position = np.asarray(position, np.float64)
        b.orientation = np.asarray(orientation, np.float64)
        b.velocity = np.zeros(3)

    def remove_body(self, body_id):
        self.bodies.pop(body_id, None)

    def num_bodies(self):
        return len(self.bodies)

    def last_body_id(self):
        return max(self.bodies.keys()) if self.bodies else -1

    def reset(self):
        self.bodies.clear()
        self._next_id = 0
        self._contacts = []
        self._ext_forces = {}
        self.time = 0.0

    # --- dynamics -----------------------------------------------------------

    def apply_external_force(self, body_id, force):
        """Accumulate a world-frame force for the NEXT step only (pybullet
        applyExternalForce semantics)."""
        self._ext_forces.setdefault(body_id, np.zeros(3))
        self._ext_forces[body_id] = self._ext_forces[body_id] + np.asarray(
            force, np.float64)

    def _reach_along(self, body: _Body, direction):
        """Support distance of the body along -direction (unit vector)."""
        if body.shape == "sphere":
            return float(body.size[0])
        rot = quat_to_matrix(body.orientation)
        return float(np.sum(np.abs(direction @ rot) * body.size))

    def _support_planes(self, body: _Body):
        """Candidate contact planes: the ground plane + the top face of every
        other box (fixed or massive), as (support_id, normal, plane_point,
        half_extents_or_None, support_rot)."""
        planes = []
        if self.GROUND_ID in self.bodies and \
                self.bodies[self.GROUND_ID].shape == "plane":
            planes.append((self.GROUND_ID, np.array([0.0, 0.0, 1.0]),
                           np.zeros(3), None, np.eye(3)))
        for bid, other in self.bodies.items():
            if other.shape != "box" or other is body:
                continue
            rot = quat_to_matrix(other.orientation)
            n = rot[:, 2]
            if n[2] < 0:
                n = -n
            plane_pt = other.position + n * other.size[2]
            planes.append((bid, n, plane_pt, other.size[:2], rot))
        return planes

    def step(self):
        dt = self.time_step
        self._contacts = []
        for bid, b in self.bodies.items():
            if b.fixed or b.shape == "plane" or b.mass <= 0:
                continue
            force = self._ext_forces.pop(bid, None)
            accel = self.gravity + (force / b.mass if force is not None else 0.0)
            b.velocity = b.velocity + accel * dt
            b.position = b.position + b.velocity * dt

            for support_id, n, plane_pt, extents, rot in self._support_planes(b):
                reach = self._reach_along(b, n)
                center_height = float(np.dot(b.position - plane_pt, n))
                d = center_height - reach
                if d >= 0:
                    continue
                if center_height <= 0:
                    # the body's CENTER is at/below the face plane: it is on
                    # the other side of (or inside) the support body, not
                    # resting on its top face. Without this guard a movable
                    # body below a box (exp_3's mass-100 sensor under the
                    # object) is "resolved" upward through it every step and
                    # both bodies leapfrog to infinity.
                    continue
                if extents is not None:
                    # lateral containment in the support face plane
                    local = rot.T @ (b.position - (plane_pt - n * 0))
                    if abs(local[0]) > extents[0] or abs(local[1]) > extents[1]:
                        continue
                # resolve penetration along the face normal
                b.position = b.position - n * d
                vn = float(np.dot(b.velocity, n))
                impulse_force = 0.0
                if vn < 0:
                    dv = -(1 + self.restitution) * vn
                    if abs(vn) < 0.5:              # settle small bounces
                        dv = -vn
                    b.velocity = b.velocity + n * dv
                    impulse_force = b.mass * dv / dt
                # tangential friction damping, relative to the support's own
                # tangential motion: a body riding a moving support is dragged
                # toward co-motion (pybullet lateral friction; exp_3's shocked
                # mass-100 sensor carries the object instead of sliding out
                # from under it). Static supports have sup_t == 0 exactly, so
                # exp_1/exp_2 trajectories are bit-identical to the
                # world-frame damping this generalises. One-way coupling: the
                # support feels no reaction (it outweighs the object 100:1
                # here; Bullet's mutual impulse would be a ~1% correction).
                vn_new = float(np.dot(b.velocity, n))
                v_t = b.velocity - n * vn_new
                sup = self.bodies[support_id]
                if sup.fixed or sup.shape == "plane" or sup.mass <= 0:
                    sup_t = np.zeros(3)
                else:
                    sup_t = sup.velocity - n * float(np.dot(sup.velocity, n))
                b.velocity = n * vn_new + sup_t + (v_t - sup_t) * self.damping
                # at rest the restoring impulse exactly cancels gravity, so it
                # IS the support force; during impact it is the impact force
                rest_force = b.mass * float(np.dot(-self.gravity, n))
                normal_force = impulse_force if impulse_force > 0 else rest_force
                contact_pt = b.position - n * reach
                self._contacts.append(Contact(
                    body_a=support_id, body_b=bid,
                    position=tuple(contact_pt),
                    normal_force=float(normal_force)))
        self.time += dt

    def contacts(self, body_id):
        """Contacts involving body_id, reported with body_a=body_id."""
        out = []
        for c in self._contacts:
            if c.body_a == body_id:
                out.append(c)
            elif c.body_b == body_id:
                out.append(Contact(body_id, c.body_a, c.position,
                                   c.normal_force))
        return out

    # --- rendering ------------------------------------------------------------

    def _ray_grid(self, camera):
        """Per-pixel unit ray directions, cached per camera pose (static
        sensors re-render with identical matrices every snapshot)."""
        h, w = camera.height, camera.width
        eye = camera.camera_eye_position.astype(np.float64)
        key = (w, h, np.asarray(camera.view_matrix).tobytes(),
               np.asarray(camera.projection_matrix).tobytes())
        cache = getattr(self, "_ray_cache", None)
        if cache is None:
            cache = self._ray_cache = {}
        hit = cache.get(id(camera))
        if hit is not None and hit[0] == key:
            return hit[1], hit[2], eye
        x = np.arange(w, dtype=np.float64)
        y = np.arange(h, dtype=np.float64)
        xm, ym = np.meshgrid(x, y)
        pix = np.stack([xm.reshape(-1), ym.reshape(-1),
                        np.full(h * w, camera.near)])
        near_pts = camera.unproject_pixel_to_3D(pix)        # (3, N)
        dirs = near_pts - eye[:, None]
        dirs = (dirs / np.linalg.norm(dirs, axis=0, keepdims=True)).astype(
            self.render_dtype)
        forward = (camera.camera_target_position - eye)
        forward = (forward / np.linalg.norm(forward)).astype(self.render_dtype)
        cache[id(camera)] = (key, dirs, forward)
        return dirs, forward, eye

    def render(self, camera, return_normals=False):
        """Raycast RGB/depth/seg through ``camera`` -> (rgb (H,W,4) uint8,
        depth z_b (H,W) float, seg (H,W) int[, normals (H,W,3) float]).
        Intersections run in float32 (sub-pixel-noise level) with cached
        per-pose ray grids."""
        h, w = camera.height, camera.width
        dirs, forward, eye64 = self._ray_grid(camera)
        eye = eye64.astype(self.render_dtype)

        n = h * w
        t_best = np.full(n, np.inf)
        seg = np.full(n, -1, dtype=np.int64)
        rgb = np.zeros((n, 3), dtype=np.float64)
        normal_map = np.zeros((n, 3), dtype=np.float64) if return_normals else None
        light_dir = np.array([0.3, 0.2, 0.93])
        light_dir = light_dir / np.linalg.norm(light_dir)

        for bid, b in self.bodies.items():
            if b.shape == "plane":
                t, normal_fn = self._ray_plane(eye, dirs)
            elif b.shape == "sphere":
                t, normal_fn = self._ray_sphere(eye, dirs, b)
            else:
                t, normal_fn = self._ray_box(eye, dirs, b)
            hit = t < t_best
            if not hit.any():
                continue
            normals = normal_fn(hit)
            lambert = 0.35 + 0.65 * np.clip(
                normals.T @ light_dir, 0, 1)
            rgb[hit] = b.color[None, :] * lambert[:, None]
            seg[hit] = bid
            t_best[hit] = t[hit]
            if normal_map is not None:
                normal_map[hit] = normals.T

        # depth: eye-space distance along forward -> buffer
        hit_any = np.isfinite(t_best)
        # float dtype explicitly: an integer far (e.g. far=8) would otherwise
        # make np.full produce an int array and silently truncate every
        # assigned eye-space depth
        z_e = np.full(n, float(camera.far), dtype=np.float64)
        pts = eye[:, None] + dirs * np.where(hit_any, t_best, 0.0)
        z_e[hit_any] = ((pts - eye[:, None]).T @ forward)[hit_any]
        z_e = np.clip(z_e, camera.near, camera.far)
        depth = camera.real_depth_to_buffer(z_e).reshape(h, w)

        rgba = np.concatenate([
            (np.clip(rgb, 0, 1) * 255).astype(np.uint8),
            np.full((n, 1), 255, np.uint8)], axis=1).reshape(h, w, 4)
        if return_normals:
            return rgba, depth, seg.reshape(h, w), normal_map.reshape(h, w, 3)
        return rgba, depth, seg.reshape(h, w)

    @staticmethod
    def _ray_plane(eye, dirs):
        denom = dirs[2]
        with np.errstate(divide="ignore", invalid="ignore"):
            t = np.where(np.abs(denom) > 1e-9, -eye[2] / denom, np.inf)
        t = np.where(t > 1e-9, t, np.inf)

        def normal_fn(hit):
            n = np.zeros((3, int(hit.sum())))
            n[2] = 1.0
            return n

        return t, normal_fn

    @staticmethod
    def _ray_sphere(eye, dirs, body):
        c = body.position.astype(eye.dtype)
        r = float(body.size[0])
        oc = (eye - c)[:, None]
        b_half = np.sum(oc * dirs, axis=0)
        disc = b_half ** 2 - (np.sum(oc * oc) - r * r)
        with np.errstate(invalid="ignore"):
            sq = np.sqrt(np.maximum(disc, 0))
        t = np.where(disc >= 0, -b_half - sq, np.inf)
        t = np.where(t > 1e-9, t, np.inf)

        def normal_fn(hit, _t=t):
            pts = eye[:, None] + dirs[:, hit] * _t[hit]
            n = pts - c[:, None]
            return n / np.linalg.norm(n, axis=0, keepdims=True)

        return t, normal_fn

    @staticmethod
    def _ray_box(eye, dirs, body):
        rot = quat_to_matrix(body.orientation).astype(eye.dtype)
        # transform ray into box frame
        o = rot.T @ (eye - body.position.astype(eye.dtype))
        d = rot.T @ dirs
        he = body.size.reshape(3, 1).astype(eye.dtype)
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = np.where(np.abs(d) > 1e-12, 1.0 / d, np.inf)
        t1 = (-he - o[:, None]) * inv
        t2 = (he - o[:, None]) * inv
        tmin = np.minimum(t1, t2).max(axis=0)
        tmax = np.maximum(t1, t2).min(axis=0)
        t = np.where((tmax >= tmin) & (tmax > 0),
                     np.where(tmin > 1e-9, tmin, np.inf), np.inf)

        def normal_fn(hit, _t=t):
            pts_local = o[:, None] + d[:, hit] * _t[hit]
            # face with the largest |coordinate|/extent is the hit face
            ratio = np.abs(pts_local) / he
            face = np.argmax(ratio, axis=0)
            n_local = np.zeros((3, int(hit.sum())))
            n_local[face, np.arange(n_local.shape[1])] = np.sign(
                pts_local[face, np.arange(n_local.shape[1])])
            return rot @ n_local

        return t, normal_fn


class PyBulletBackend(PhysicsBackend):
    """Bullet-backed implementation (lazy import)."""

    def __init__(self, time_step=config.TIME_STEP, renders=False,
                 load_plane=True, gravity=True, plane_urdf="plane100.urdf"):
        import pybullet as p
        import pybullet_data
        self._p = p
        if renders:
            cid = p.connect(p.GUI)
            if cid < 0:
                p.connect(p.GUI)
            p.resetDebugVisualizerCamera(1, 0, -20, [0.0, 0.0, 1.0])
        else:
            p.connect(p.DIRECT)
        p.setAdditionalSearchPath(pybullet_data.getDataPath())
        p.setTimeStep(time_step)
        if load_plane:
            p.loadURDF(plane_urdf)
        if gravity:
            p.setGravity(0, 0, -10)
        self.time_step = time_step

    def step(self):
        self._p.stepSimulation()

    def render(self, camera):
        p = self._p
        # Bullet consumes column-major flattened matrices (camera.py:359-363)
        _, _, rgb, depth, seg = p.getCameraImage(
            camera.width, camera.height,
            np.asarray(camera.view_matrix).reshape(-1, order="F"),
            np.asarray(camera.projection_matrix).reshape(-1, order="F"),
            renderer=p.ER_BULLET_HARDWARE_OPENGL)
        return rgb, depth, seg

    def get_pose(self, body_id):
        return self._p.getBasePositionAndOrientation(body_id)

    def set_pose(self, body_id, position, orientation):
        self._p.resetBasePositionAndOrientation(body_id, position, orientation)

    def contacts(self, body_id):
        pts = self._p.getContactPoints(body_id)
        return [Contact(body_a=c[1], body_b=c[2], position=tuple(c[5]),
                        normal_force=c[9]) for c in pts]

    def apply_external_force(self, body_id, force):
        self._p.applyExternalForce(body_id, -1, list(force), [0, 0, 0],
                                   self._p.WORLD_FRAME)

    def remove_body(self, body_id):
        self._p.removeBody(body_id)

    def num_bodies(self):
        return self._p.getNumBodies()

    def last_body_id(self):
        return self._p.getBodyUniqueId(self._p.getNumBodies() - 1)

    def reset(self):
        self._p.resetSimulation()

    def disconnect(self):
        self._p.disconnect()

    @property
    def pybullet(self):
        return self._p


def setup_backend(time_step=config.TIME_STEP, renders=False, load_plane=True,
                  gravity=True, engine="auto") -> PhysicsBackend:
    """Engine selection: 'pybullet', 'analytic', or 'auto' (pybullet if
    importable, analytic otherwise). Mirrors setup_pybullet
    (mmdyn/tact_sim/utils/pybullet.py:8-37) plus the fallback."""
    if engine == "auto":
        try:
            import pybullet  # noqa: F401
            engine = "pybullet"
        except ImportError:
            engine = "analytic"
    if engine == "pybullet":
        return PyBulletBackend(time_step=time_step, renders=renders,
                               load_plane=load_plane, gravity=gravity)
    g = (0, 0, -10) if gravity else (0, 0, 0)
    return AnalyticBackend(time_step=time_step, gravity=g,
                           load_plane=load_plane)
