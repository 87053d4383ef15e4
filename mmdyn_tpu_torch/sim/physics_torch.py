"""Batched analytic rigid-body stepping on a device (port of
``mmdyn_tpu/sim/physics_jax.py``).

The host engine (``sim/physics.py::AnalyticBackend``) steps one scene at a
time in float64 numpy: semi-implicit Euler under gravity, then sequential
impulse contact against the ground plane and the upward face of every box.
The experiment CLIs run many independent trials of one small scene (3-4
bodies), so this module packs a scene's signature once and steps K trials
together in float32: the trials are the leading axis of every tensor, the T
steps a Python loop, and positions and contact normal forces for all of them
come back from one call.

The step is the exact port of ``AnalyticBackend.step``: support planes from
the ground and every other box's upward face; bodies resolved in ascending
id order, each reading the latest position and velocity of the bodies
already stepped this tick; the centre-above-face guard; the ``|vn| < 0.5``
settling branch; tangential damping relative to the support's own velocity;
the ground normal force at rest; pybullet ``applyExternalForce`` one-step
semantics. Parity: ``tests/test_torch_sim.py`` against ``SimulatorJax`` and
the host engine.

Orientations never change in the analytic engine (it has no angular
dynamics), so everything that depends only on orientation and size (the
rotation matrices, the support normals, each body's reach along each
normal, the force of gravity along each normal) is computed once per rollout
rather than once per step: the same arithmetic on the same values.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from mmdyn_tpu_torch.utils.device import as_device_tensor, resolve_device


def quat_rot(q):
    """Rotation matrices (..., 3, 3) of xyzw quaternions ``q`` (..., 4), with
    pybullet's normalisation (``sim/raycast_torch.py`` uses the same)."""
    x, y, z, w = q.unbind(-1)
    n = x * x + y * y + z * z + w * w
    s = torch.where(n > 0, 2.0 / torch.clamp(n, min=1e-30), torch.zeros_like(n))
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    rows = ((1.0 - (yy + zz), xy - wz, xz + wy),
            (xy + wz, 1.0 - (xx + zz), yz - wx),
            (xz - wy, yz + wx, 1.0 - (xx + yy)))
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _dot(a, b):
    """Row-wise dot product of (K, 3) tensors, summed in component order."""
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


class SimulatorTorch:
    """Batched stepper for one scene *signature* on one device.

    The signature (per-body shape, movability, ground presence) fixes the
    unrolled body and support loops. Sizes, masses, orientations, the initial
    state and external forces are arguments, so one simulator serves every
    trial drawn from a catalog with the same body composition.

    Body order is ascending backend id (the host's dict iteration order).
    Contact forces come back as a dense (NB, NS) matrix per step: slot 0 is
    the ground plane, slots 1..n the box bodies in id order
    (``support_slot`` maps a body to its slot).
    """

    def __init__(self, shapes: Tuple[str, ...], movable: Tuple[bool, ...],
                 time_step: float, gravity, restitution: float, damping: float,
                 device=None):
        self.shapes = tuple(shapes)
        self.movable = tuple(bool(m) for m in movable)
        self.time_step = float(time_step)
        self.gravity = np.asarray(gravity, np.float32)
        self.restitution = float(restitution)
        self.damping = float(damping)
        self.device = resolve_device(device)
        self.has_plane = bool(shapes) and shapes[0] == "plane"
        self._boxes = [i for i, s in enumerate(self.shapes) if s == "box"]
        # support slot 0 = the ground, then the boxes in id order
        self.n_supports = 1 + len(self._boxes)
        self._slot_of = {b: 1 + k for k, b in enumerate(self._boxes)}

    def support_slot(self, body_index: int) -> int:
        """Contact-matrix column of a box body (column 0 is the ground)."""
        return self._slot_of[body_index]

    def _supports(self, i):
        """(support body or None for the ground, slot) of body ``i``."""
        out = [(None, 0)] if self.has_plane else []
        return out + [(j, self._slot_of[j]) for j in self._boxes if j != i]

    def _geometry(self, quat, sizes, mass):
        """What the contact tests read that depends on orientation and size
        only, per (body, support): the support's normal and rotation, the
        body's reach along the normal and its weight along it."""
        k = quat.shape[0]
        rot = quat_rot(quat)                                   # (K, NB, 3, 3)
        ground = torch.zeros(k, 3, device=self.device)
        ground[:, 2] = 1.0
        g = torch.as_tensor(self.gravity, device=self.device)
        geo = {}
        for i, shape in enumerate(self.shapes):
            if not self.movable[i]:
                continue
            for j, slot in self._supports(i):
                if j is None:
                    n = ground
                else:
                    col = rot[:, j, :, 2]
                    n = torch.where(col[:, 2:3] < 0, -col, col)
                if shape == "sphere":
                    reach = sizes[:, i, 0]
                else:
                    # sum_c |n . R_i[:, c]| * size_c (physics.py::_reach_along)
                    ndotr = (n[:, 0:1] * rot[:, i, 0] + n[:, 1:2] * rot[:, i, 1]
                             + n[:, 2:3] * rot[:, i, 2])
                    a = ndotr.abs() * sizes[:, i]
                    reach = a[:, 0] + a[:, 1] + a[:, 2]
                rest_force = mass[:, i] * (-g[0] * n[:, 0] - g[1] * n[:, 1] - g[2] * n[:, 2])
                geo[i, j] = dict(n=n, slot=slot, reach=reach, rest_force=rest_force,
                                 rot=None if j is None else rot[:, j],
                                 lift=None if j is None else n * sizes[:, j, 2:3])
        return geo

    def _step(self, pos, vel, sizes, mass, force, geo):
        """One tick. ``pos`` / ``vel``: lists of NB (K, 3) tensors, replaced
        body by body (never written in place, so a body stepped later reads
        the new rows of the bodies before it); ``force``: (K, NB, 3) or None.
        Returns the new lists and {(body, slot): (K,) normal force}."""
        dt = self.time_step
        g = torch.as_tensor(self.gravity, device=self.device)
        pos, vel, cf = list(pos), list(vel), {}
        for i in range(len(self.shapes)):
            if not self.movable[i]:
                continue
            accel = g if force is None else g + force[:, i] / mass[:, i:i + 1]
            v = vel[i] + accel * dt
            p = pos[i] + v * dt
            m_i = mass[:, i]
            for j, _ in self._supports(i):
                c = geo[i, j]
                n = c["n"]
                # p - plane_pt; the ground's plane point is the origin
                rel = p if j is None else p - (pos[j] + c["lift"])
                center_height = _dot(rel, n)
                d = center_height - c["reach"]
                active = (d < 0) & (center_height > 0)
                if j is not None:
                    # lateral containment in the support face plane
                    r_j = c["rot"]
                    local0 = r_j[:, 0, 0] * rel[:, 0] + r_j[:, 1, 0] * rel[:, 1] \
                        + r_j[:, 2, 0] * rel[:, 2]
                    local1 = r_j[:, 0, 1] * rel[:, 0] + r_j[:, 1, 1] * rel[:, 1] \
                        + r_j[:, 2, 1] * rel[:, 2]
                    active = active & (local0.abs() <= sizes[:, j, 0]) \
                        & (local1.abs() <= sizes[:, j, 1])
                act = active[:, None]
                # resolve penetration along the face normal
                p = torch.where(act, p - n * d[:, None], p)
                vn = _dot(v, n)
                neg = active & (vn < 0)
                dv = torch.where(vn.abs() < 0.5, -vn, -(1.0 + self.restitution) * vn)
                v = torch.where(neg[:, None], v + n * dv[:, None], v)
                impulse = torch.where(neg, m_i * dv / dt, torch.zeros_like(dv))
                # tangential friction damping relative to the support's own
                # tangential motion, its LATEST velocity this tick (static
                # supports: sup_t == 0 exactly)
                vn_new = _dot(v, n)[:, None]
                v_t = v - n * vn_new
                if j is None or not self.movable[j]:
                    damped = n * vn_new + v_t * self.damping
                else:
                    sv = vel[j]
                    sup_t = sv - n * _dot(sv, n)[:, None]
                    damped = n * vn_new + sup_t + (v_t - sup_t) * self.damping
                v = torch.where(act, damped, v)
                normal_force = torch.where(impulse > 0, impulse, c["rest_force"])
                cf[i, c["slot"]] = torch.where(active, normal_force,
                                               torch.zeros_like(normal_force))
            pos[i], vel[i] = p, v
        return pos, vel, cf

    @torch.no_grad()
    def simulate(self, pos, vel, quat, sizes, mass, n_steps: int,
                 ext_forces: Optional[np.ndarray] = None):
        """Batched rollout.

        Args (leading axis K = trials): pos, vel (K, NB, 3); quat (K, NB, 4);
            sizes (K, NB, 3) (a sphere's radius in column 0); mass (K, NB);
            ext_forces (K, T, NB, 3) world-frame forces applied during step t
            (pybullet applyExternalForce one-step semantics), or None.

        Returns a dict of tensors on the simulator's device:
            pos (K, T, NB, 3), the pose BEFORE step t (pos[:, 0] is the
            initial state, as the experiments snapshot before they step);
            contact_force (K, T, NB, NS), the normal forces DURING step t (a
            snapshot at iteration t reads those of step t-1);
            final_pos, final_vel (K, NB, 3).
        """
        f32 = lambda a: as_device_tensor(a, torch.float32, self.device)  # noqa: E731
        pos, vel, quat, sizes, mass = (f32(a) for a in (pos, vel, quat, sizes, mass))
        force = None if ext_forces is None else f32(ext_forces)
        k, nb = pos.shape[:2]
        n_steps = int(n_steps)
        geo = self._geometry(quat, sizes, mass)
        p, v = list(pos.unbind(1)), list(vel.unbind(1))
        traj = {i: [] for i in range(nb) if self.movable[i]}
        forces = {}
        for t in range(n_steps):
            for i in traj:
                traj[i].append(p[i])
            p, v, cf = self._step(p, v, sizes, mass,
                                  None if force is None else force[:, t], geo)
            for key, f in cf.items():
                forces.setdefault(key, []).append(f)
        out_pos = pos[:, None].expand(k, n_steps, nb, 3).clone()
        for i, rows in traj.items():
            out_pos[:, :, i] = torch.stack(rows, 1)
        contact = torch.zeros(k, n_steps, nb, self.n_supports, device=self.device)
        for (i, slot), rows in forces.items():
            contact[:, :, i, slot] = torch.stack(rows, 1)
        return {"pos": out_pos, "contact_force": contact,
                "final_pos": torch.stack(p, 1), "final_vel": torch.stack(v, 1)}


def pack_scene(backend, device=None):
    """Pack an AnalyticBackend's bodies for ``SimulatorTorch``.

    Returns (sim, ids, consts): ``sim`` keyed by the scene's static signature
    and device (shared by backends of the same body composition through
    ``cached_simulator``), ``ids`` the backend body id of each row, and
    ``consts`` this scene's per-body numpy arrays (quat, sizes, mass) and its
    current state (pos, vel).
    """
    ids = sorted(backend.bodies)
    nb = len(ids)
    shapes, movable = [], []
    sizes = np.zeros((nb, 3), np.float32)
    mass = np.ones(nb, np.float32)
    quat = np.zeros((nb, 4), np.float32)
    pos = np.zeros((nb, 3), np.float32)
    vel = np.zeros((nb, 3), np.float32)
    for k, bid in enumerate(ids):
        b = backend.bodies[bid]
        shapes.append(b.shape)
        movable.append((not b.fixed) and b.shape != "plane" and b.mass > 0)
        sz = np.asarray(b.size, np.float64).reshape(-1)
        sizes[k, :sz.shape[0]] = sz
        mass[k] = max(b.mass, 1e-9)
        quat[k] = np.asarray(b.orientation, np.float64)
        pos[k] = np.asarray(b.position, np.float64)
        vel[k] = np.asarray(b.velocity, np.float64)
    sim = cached_simulator(tuple(shapes), tuple(movable), backend.time_step,
                           tuple(np.asarray(backend.gravity, np.float64)),
                           backend.restitution, backend.damping, device=device)
    consts = {"sizes": sizes, "mass": mass, "quat": quat, "pos": pos, "vel": vel}
    return sim, ids, consts


_SIM_CACHE = {}


def cached_simulator(shapes, movable, time_step, gravity, restitution, damping,
                     device=None) -> SimulatorTorch:
    """One SimulatorTorch per static scene signature and device."""
    device = resolve_device(device)
    key = (tuple(shapes), tuple(movable), float(time_step),
           tuple(float(x) for x in gravity), float(restitution), float(damping), str(device))
    if key not in _SIM_CACHE:
        _SIM_CACHE[key] = SimulatorTorch(shapes, movable, time_step, gravity,
                                         restitution, damping, device=device)
    return _SIM_CACHE[key]
