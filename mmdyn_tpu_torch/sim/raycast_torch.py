"""Batched analytic raycasting on a device (port of
``mmdyn_tpu/sim/raycast_jax.py``).

``AnalyticBackend.render`` raycasts one frame at a time on the host. For the
plane / sphere / box scenes the experiment CLIs generate, the visual RGB, the
depth buffer and the segmentation are pure functions of (camera state, body
states), so whole rollouts render as one batch on the card:

    rc = RaycastTorch.from_camera(camera)
    rgb, depth, seg = rc.render_frames(cam_states, scene)

With ``TactileRendererTorch``, which reads the clipped depth buffer, the
frame pipeline stays on the device: per snapshot only the body poses go up,
and the finished uint8 frames come down.

The numerics follow ``AnalyticBackend.render`` (physics.py::render,
_ray_plane / _ray_sphere / _ray_box) in float32: the ray grid from the
inverse view-projection, hits resolved strictly-closer-wins in ascending body
id, the Lambert headlight, the eye-space -> buffer depth conversion
(camera.real_depth_to_buffer). The work is done on (F, H, W) component grids;
per-frame scalars are (F, 1, 1) views and the pixel grid is made on the
device. Parity: ``tests/test_torch_sim.py`` against ``RaycastJax`` and the
host engine.
"""

from __future__ import annotations

import numpy as np
import torch

from mmdyn_tpu_torch.sim.physics_torch import quat_rot
from mmdyn_tpu_torch.utils.device import as_device_tensor, resolve_device

# the AnalyticBackend's fixed headlight (physics.py::render)
_LIGHT = np.array([0.3, 0.2, 0.93])
_LIGHT = _LIGHT / np.linalg.norm(_LIGHT)
_INF = float("inf")


class RaycastTorch:
    """Batched plane / sphere / box raycaster matching AnalyticBackend.render.

    Construction fixes the camera intrinsics (width, height, near, far and
    the projection entries of the depth-buffer conversion) and the device;
    the per-frame extrinsics (inverse view-projection, eye, forward) and body
    states are arguments, so one renderer serves a moving sensor and any
    number of trials of one scene signature.
    """

    def __init__(self, width, height, near, far, proj_a, proj_b, device=None):
        self._width, self._height = int(width), int(height)
        self._near, self._far = float(near), float(far)
        self._proj_a, self._proj_b = float(proj_a), float(proj_b)
        self.device = resolve_device(device)

    @classmethod
    def from_camera(cls, camera, device=None):
        proj = np.asarray(camera.projection_matrix, np.float64)
        return cls(camera.width, camera.height, camera.near, camera.far,
                   proj[2, 2], proj[2, 3], device=device)

    @staticmethod
    def capture_camera_state(camera):
        """(m_inv, eye, forward) float32 numpy snapshot of the current pose."""
        m = np.matmul(np.asarray(camera.projection_matrix),
                      np.asarray(camera.view_matrix))
        eye = np.asarray(camera.camera_eye_position, np.float64)
        fwd = np.asarray(camera.camera_target_position, np.float64) - eye
        fwd = fwd / np.linalg.norm(fwd)
        return (np.linalg.inv(m).astype(np.float32),
                eye.astype(np.float32), fwd.astype(np.float32))

    # per-frame math ---------------------------------------------------------

    def _rays(self, m_inv, eye):
        """Unit ray directions through every pixel of the near plane, as 3
        (F, H, W) component grids (the _ray_grid math, physics.py:255-280).
        ``m_inv`` (F, 4, 4), ``eye`` (F, 3)."""
        xm = torch.arange(self._width, dtype=torch.float32, device=self.device)
        ym = torch.arange(self._height, dtype=torch.float32, device=self.device)
        x_ndc = (2.0 * xm / self._width - 1.0).view(1, 1, -1)
        y_ndc = (2.0 * ym / self._height - 1.0).view(1, -1, 1)
        m = lambda i, j: m_inv[:, i, j].view(-1, 1, 1)  # noqa: E731
        # window z = near -> ndc z = -1, w = 1
        world = [m(i, 0) * x_ndc + m(i, 1) * y_ndc - m(i, 2) + m(i, 3) for i in range(4)]
        d = [world[c] / world[3] - eye[:, c].view(-1, 1, 1) for c in range(3)]
        norm = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
        return [c / norm for c in d]

    def _render(self, m_inv, eye, forward, sph_pos, sph_r, sph_col, sph_id, box_pos,
                box_q, box_he, box_col, box_id, plane_col, has_plane):
        d = self._rays(m_inv, eye)
        e = [eye[:, c].view(-1, 1, 1) for c in range(3)]
        t_best = torch.full_like(d[0], _INF)
        seg = torch.full(d[0].shape, -1, dtype=torch.int32, device=self.device)
        rgb = [torch.zeros_like(d[0]) for _ in range(3)]

        def shade(col, n):
            lam = 0.35 + 0.65 * torch.clamp(
                n[0] * _LIGHT[0] + n[1] * _LIGHT[1] + n[2] * _LIGHT[2], 0.0, 1.0)
            return [col[c] * lam for c in range(3)]

        def update(t, bid, shaded):
            nonlocal t_best, seg, rgb
            closer = t < t_best
            seg = torch.where(closer, bid, seg)
            rgb = [torch.where(closer, s, c) for s, c in zip(shaded, rgb)]
            t_best = torch.minimum(t, t_best)

        # bodies in ascending id order = the host's strictly-closer-wins
        # iteration (the plane is always id 0 in AnalyticBackend)
        if has_plane:
            t = torch.where(d[2].abs() > 1e-9, -e[2] / d[2], _INF)
            t = torch.where(t > 1e-9, t, _INF)
            n = (torch.zeros_like(t), torch.zeros_like(t), torch.ones_like(t))
            update(t, torch.tensor(0, dtype=torch.int32, device=self.device),
                   shade(plane_col, n))

        for s in range(sph_r.shape[0]):
            oc = [e[c] - sph_pos[:, s, c].view(-1, 1, 1) for c in range(3)]
            b_half = oc[0] * d[0] + oc[1] * d[1] + oc[2] * d[2]
            oc2 = oc[0] * oc[0] + oc[1] * oc[1] + oc[2] * oc[2]
            disc = b_half * b_half - (oc2 - sph_r[s] * sph_r[s])
            t = torch.where(disc >= 0, -b_half - torch.sqrt(torch.clamp(disc, min=0.0)),
                            _INF)
            t = torch.where(t > 1e-9, t, _INF)
            n = [oc[c] + d[c] * t for c in range(3)]
            nn = torch.sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2])
            finite = torch.isfinite(nn)
            safe = torch.clamp(torch.where(finite, nn, 1.0), min=1e-30)
            n = [torch.where(finite, c / safe, 0.0) for c in n]
            update(t, sph_id[s], shade(sph_col[s], n))

        for b in range(box_he.shape[0]):
            rot = quat_rot(box_q[:, b]).view(-1, 3, 3, 1, 1)     # (F, 3, 3, 1, 1)
            r = lambda i, j: rot[:, i, j]  # noqa: E731
            rel = [e[c] - box_pos[:, b, c].view(-1, 1, 1) for c in range(3)]
            # box frame: o = R^T rel, dl = R^T d
            o = [r(0, c) * rel[0] + r(1, c) * rel[1] + r(2, c) * rel[2] for c in range(3)]
            dl = [r(0, c) * d[0] + r(1, c) * d[1] + r(2, c) * d[2] for c in range(3)]
            tmin = torch.full_like(d[0], -_INF)
            tmax = torch.full_like(d[0], _INF)
            for c in range(3):
                invc = torch.where(dl[c].abs() > 1e-12, 1.0 / dl[c], _INF)
                ta = (-box_he[b, c] - o[c]) * invc
                tb = (box_he[b, c] - o[c]) * invc
                tmin = torch.maximum(tmin, torch.minimum(ta, tb))
                tmax = torch.minimum(tmax, torch.maximum(ta, tb))
            t = torch.where((tmax >= tmin) & (tmax > 0),
                            torch.where(tmin > 1e-9, tmin, _INF), _INF)
            tl = torch.where(torch.isfinite(t), t, 0.0)
            pl = [o[c] + dl[c] * tl for c in range(3)]
            ratio = [pl[c].abs() / box_he[b, c] for c in range(3)]
            # the face with the largest |coordinate| / extent is the hit face
            m01 = ratio[0] >= ratio[1]
            mx = torch.where(m01, ratio[0], ratio[1])
            face_is_z = ratio[2] > mx
            nl = [torch.where(face_is_z, 0.0, torch.where(m01, torch.sign(pl[0]), 0.0)),
                  torch.where(face_is_z, 0.0, torch.where(m01, 0.0, torch.sign(pl[1]))),
                  torch.where(face_is_z, torch.sign(pl[2]), 0.0)]
            n = [r(c, 0) * nl[0] + r(c, 1) * nl[1] + r(c, 2) * nl[2] for c in range(3)]
            update(t, box_id[b], shade(box_col[b], n))

        hit = torch.isfinite(t_best)
        f = [forward[:, c].view(-1, 1, 1) for c in range(3)]
        ddotf = d[0] * f[0] + d[1] * f[1] + d[2] * f[2]
        z_e = torch.where(hit, t_best * ddotf, self._far)
        z_e = torch.clamp(z_e, self._near, self._far)
        depth = 0.5 * (-self._proj_a + self._proj_b / z_e) + 0.5
        # clip * 255 truncates toward zero, as numpy's astype(uint8)
        rgba = torch.stack([(torch.clamp(c, 0.0, 1.0) * 255.0).to(torch.uint8) for c in rgb]
                           + [torch.full_like(seg, 255, dtype=torch.uint8)], dim=-1)
        return rgba, depth, seg

    def _inputs(self, cam_states, scene):
        f32 = lambda a: as_device_tensor(a, torch.float32, self.device)  # noqa: E731
        i32 = lambda a: as_device_tensor(a, torch.int32, self.device)  # noqa: E731
        return dict(
            m_inv=f32(cam_states["m_inv"]), eye=f32(cam_states["eye"]),
            forward=f32(cam_states["forward"]),
            sph_pos=f32(scene["sph_pos"]), sph_r=f32(scene["sph_r"]),
            sph_col=f32(scene["sph_col"]), sph_id=i32(scene["sph_id"]),
            box_pos=f32(scene["box_pos"]), box_q=f32(scene["box_q"]),
            box_he=f32(scene["box_he"]), box_col=f32(scene["box_col"]),
            box_id=i32(scene["box_id"]), plane_col=f32(scene["plane_col"]),
            has_plane=bool(scene["has_plane"]))

    @torch.no_grad()
    def render_frames(self, cam_states, scene):
        """Render a batch of frames.

        Args:
            cam_states: dict with 'm_inv' (F, 4, 4), 'eye' (F, 3), 'forward'
                (F, 3), from ``capture_camera_state`` per frame.
            scene: dict with per-scene arrays 'sph_r' (S,), 'sph_col' (S, 3),
                'sph_id' (S,), 'box_he' (B, 3), 'box_col' (B, 3), 'box_id'
                (B,), 'plane_col' (3,), 'has_plane' (bool) and per-frame
                arrays 'sph_pos' (F, S, 3), 'box_pos' (F, B, 3), 'box_q'
                (F, B, 4). numpy arrays, or tensors on the renderer's device.

        Returns tensors on the renderer's device:
            (rgba (F, H, W, 4) uint8, depth (F, H, W) f32, seg (F, H, W) i32)
        """
        return self._render(**self._inputs(cam_states, scene))

    @torch.no_grad()
    def render_frames_packed(self, cam_states, scene, max_buffer_depth, obj_ids, mask=True):
        """``render_frames`` packed to the dump's PNG payloads on the device:

        * rgb (F, H, W, 3) uint8, the visual PNG (alpha dropped);
        * depth_clip (F, H, W) f32, the buffer clipped at ``max_buffer_depth``
          (sensor.py:305-306), left on the device for the tactile renderer;
        * depth_png (F, H, W) uint8, camera.save_image's ``(d * 255) -> u8``
          of depth_clip;
        * seg_png (F, H, W) uint8, the segmentation masked to ``obj_ids`` (F,)
          when ``mask``, after save_image's ``(seg * 255) -> u8`` wrap: -1 ->
          1, id k -> (-k) mod 256.
        """
        inputs = self._inputs(cam_states, scene)
        rgba, depth, seg = self._render(**inputs)
        depth_clip = torch.clamp(depth, max=float(np.float32(max_buffer_depth)))
        # the buffer lies in [0, 1]; the clamp at 0 only keeps the cast in range
        depth_png = torch.clamp(depth_clip * 255.0, min=0.0).to(torch.uint8)
        if mask:
            oid = as_device_tensor(obj_ids, torch.int32, self.device).view(-1, 1, 1)
            seg = torch.where(seg != oid, -1, oid).to(torch.int32)
        seg_png = torch.remainder(seg * 255, 256).to(torch.uint8)
        return rgba[..., :3], depth_clip, depth_png, seg_png


def capture_scene(backend):
    """Snapshot an AnalyticBackend's bodies for device raycasting.

    Returns (signature, static, frame): ``signature`` names a scene's body
    layout (counts and ids), ``static`` holds the per-scene constants
    (sizes, colours, ids) and ``frame`` the poses. Bodies are sorted by id so
    the device's hit resolution matches the host's iteration order.
    """
    spheres, boxes = [], []
    plane_col, has_plane = np.zeros(3), False
    for bid in sorted(backend.bodies):
        b = backend.bodies[bid]
        if b.shape == "plane":
            has_plane, plane_col = True, np.asarray(b.color, np.float64)
        elif b.shape == "sphere":
            spheres.append((bid, b))
        else:
            boxes.append((bid, b))
    signature = (has_plane, tuple(i for i, _ in spheres), tuple(i for i, _ in boxes))
    static = {
        "sph_r": np.array([b.size[0] for _, b in spheres], np.float32),
        "sph_col": np.array([b.color for _, b in spheres], np.float32).reshape(len(spheres), 3),
        "sph_id": np.array([i for i, _ in spheres], np.int32),
        "box_he": np.array([b.size for _, b in boxes], np.float32).reshape(len(boxes), 3),
        "box_col": np.array([b.color for _, b in boxes], np.float32).reshape(len(boxes), 3),
        "box_id": np.array([i for i, _ in boxes], np.int32),
        "plane_col": plane_col.astype(np.float32),
        "has_plane": has_plane,
    }
    frame = {
        "sph_pos": np.array([b.position for _, b in spheres], np.float32).reshape(
            len(spheres), 3),
        "box_pos": np.array([b.position for _, b in boxes], np.float32).reshape(len(boxes), 3),
        "box_q": np.array([b.orientation for _, b in boxes], np.float32).reshape(len(boxes), 4),
    }
    return signature, static, frame
