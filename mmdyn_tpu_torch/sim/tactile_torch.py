"""Batched tactile rendering on a device (port of
``mmdyn_tpu/sim/tactile_jax.py``).

The host tactile pipeline (``TactileSensor.get_sensor_pointcloud`` +
``get_tactile_image``: unproject -> normals -> Phong -> darken,
sensor.py:383-445) renders one frame at a time. The tactile image is a pure
function of the clipped depth buffer and the camera and light state, so the
pipeline runs over a batch of depth frames on the card:

    renderer = TactileRendererTorch.from_sensor(sensor)
    tactile = renderer(depth_batch)          # (B, H, W) -> (B, H, W, 3) uint8

The numerics follow the host pipeline: the same unprojection, the same
central-difference grid normals oriented to the camera, the same Phong sum
and penetration darkening in float32, then ``rint`` (half to even) and the
reference's uint8 wrap of over-darkened pixels. Every stage works on
(B, H, W) component grids; per-frame camera and light quantities are
(B, 1, 1) views. The caller chunks the frames (the JAX package's dump path
renders 128 at a time). Parity: ``tests/test_torch_sim.py`` against
``TactileRendererJax`` and the host pipeline.
"""

from __future__ import annotations

import numpy as np
import torch

from mmdyn_tpu_torch.utils.device import as_device_tensor, resolve_device


def _cdx(a):
    """Central differences along W, one-sided at the borders."""
    return torch.cat([a[..., 1:2] - a[..., 0:1], a[..., 2:] - a[..., :-2],
                      a[..., -1:] - a[..., -2:-1]], dim=-1)


def _cdy(a):
    """Central differences along H, one-sided at the borders."""
    return torch.cat([a[..., 1:2, :] - a[..., 0:1, :], a[..., 2:, :] - a[..., :-2, :],
                      a[..., -1:, :] - a[..., -2:-1, :]], dim=-2)


class TactileRendererTorch:
    def __init__(self, view_matrix, projection_matrix, width, height, near, far,
                 camera_eye, light_dirs, i_diffuses, i_speculars, k_diffuse, k_specular,
                 k_ambient, ambient, alpha, background_color, max_buffer_depth,
                 layer_thickness, darkening_factor, device=None):
        self.device = resolve_device(device)
        m = np.matmul(np.asarray(projection_matrix), np.asarray(view_matrix))
        self._m_inv = np.linalg.inv(m).astype(np.float32)
        self._width, self._height = int(width), int(height)
        self._near, self._far = float(near), float(far)
        self._eye = np.asarray(np.asarray(camera_eye, np.float64), np.float32)
        self._light_dirs = np.stack(light_dirs).astype(np.float32)          # (L, 3)
        # the intensities are constants of the renderer, read as floats
        self._i_d = np.stack(i_diffuses).astype(np.float32).tolist()        # L x 3
        self._i_s = np.stack(i_speculars).astype(np.float32).tolist()
        self._k_diffuse = float(k_diffuse)
        self._k_specular = float(k_specular)
        self._k_ambient = float(k_ambient)
        self._ambient = float(ambient)
        self._alpha = float(alpha)
        self._bg = np.asarray(np.asarray(background_color[:3], np.float64),
                              np.float32).tolist()
        self._max_depth = float(max_buffer_depth)
        self._thickness = float(layer_thickness)
        self._dark = float(darkening_factor)

    # renderers keyed by the camera and shader constants: the data-collection
    # CLIs make one sensor per trial, and identical trials share a renderer
    _cache = {}

    @classmethod
    def cached_from_sensor(cls, sensor, device=None):
        """``from_sensor`` with one renderer per configuration and device."""
        sensor._set_lights(i_specular=2.0, i_diffuse=2.0)
        cam = sensor.camera
        key = (
            tuple(np.asarray(cam.view_matrix).ravel().tolist()),
            tuple(np.asarray(cam.projection_matrix).ravel().tolist()),
            cam.width, cam.height, float(cam.near), float(cam.far),
            tuple(np.asarray(sensor.background_color).ravel().tolist()),
            float(sensor.max_buffer_depth), float(sensor.layer_thickness),
            float(sensor._darkening_factor),
            tuple(np.concatenate([np.asarray(light.direction).ravel()
                                  for light in sensor._shader.lights]).tolist()),
            str(resolve_device(device)),
        )
        if key not in cls._cache:
            cls._cache[key] = cls.from_sensor(sensor, device=device)
        return cls._cache[key]

    @classmethod
    def from_sensor(cls, sensor, device=None, i_specular=2.0, i_diffuse=2.0):
        """Snapshot a TactileSensor's camera and shader configuration. Call
        after at least one ``get_sensor_image()`` so the view matrix is set.
        The four edge lights take the given intensities; the defaults are
        the configuration of get_tactile_image (sensor.py:429)."""
        sensor._set_lights(i_specular=i_specular, i_diffuse=i_diffuse)
        cam = sensor.camera
        sh = sensor._shader
        return cls(
            view_matrix=cam.view_matrix,
            projection_matrix=cam.projection_matrix,
            width=cam.width, height=cam.height,
            near=cam.near, far=cam.far,
            camera_eye=cam.camera_eye_position,
            light_dirs=[np.asarray(light.direction).reshape(3) for light in sh.lights],
            i_diffuses=[np.asarray(light.i_diffuse).reshape(3) for light in sh.lights],
            i_speculars=[np.asarray(light.i_specular).reshape(3) for light in sh.lights],
            k_diffuse=sh._k_diffuse, k_specular=sh._k_specular,
            k_ambient=sh._k_ambient, ambient=sh._ambient_lightning,
            alpha=sh._alpha,
            background_color=sensor.background_color,
            max_buffer_depth=float(sensor.max_buffer_depth),
            layer_thickness=sensor.layer_thickness,
            darkening_factor=sensor._darkening_factor,
            device=device,
        )

    @staticmethod
    def capture_frame_state(sensor):
        """Per-frame camera and light state of a possibly moving sensor (the
        exp_3 shock displaces it): (m_inv, eye, light_dirs) numpy arrays at
        the camera's current pose, for ``render_frames``."""
        cam = sensor.camera
        m = np.matmul(np.asarray(cam.projection_matrix), np.asarray(cam.view_matrix))
        dirs = np.stack([-sensor._surface_vec_1, sensor._surface_vec_1,
                         -sensor._surface_vec_2, sensor._surface_vec_2])
        return (np.linalg.inv(m).astype(np.float32),
                np.asarray(cam.camera_eye_position, np.float32),
                dirs.astype(np.float32))

    def _render(self, depth, m_inv, eye, dirs):
        """(B, H, W) depth, (B, 4, 4) m_inv, (B, 3) eye, (B, L, 3) light
        directions -> (B, H, W, 3) uint8."""
        col = lambda a, *idx: a[(slice(None),) + idx].view(-1, 1, 1)  # noqa: E731
        # unproject: window -> ndc -> world (the camera.py pipeline)
        z_w = (self._far - self._near) * depth + self._near
        xm = torch.arange(self._width, dtype=torch.float32, device=self.device)
        ym = torch.arange(self._height, dtype=torch.float32, device=self.device)
        x_ndc = (2.0 * xm / self._width - 1.0).view(1, 1, -1)
        y_ndc = (2.0 * ym / self._height - 1.0).view(1, -1, 1)
        z_ndc = (2.0 * z_w - (self._far + self._near)) / (self._far - self._near)
        world = [col(m_inv, i, 0) * x_ndc + col(m_inv, i, 1) * y_ndc
                 + col(m_inv, i, 2) * z_ndc + col(m_inv, i, 3) for i in range(4)]
        pt = [world[c] / world[3] for c in range(3)]

        # central-difference grid normals oriented towards the camera
        # (normals.py::grid_normals)
        dx = [_cdx(p) for p in pt]
        dy = [_cdy(p) for p in pt]
        n = [dx[1] * dy[2] - dx[2] * dy[1],
             dx[2] * dy[0] - dx[0] * dy[2],
             dx[0] * dy[1] - dx[1] * dy[0]]
        norm = torch.sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2])
        safe = torch.clamp(norm, min=1e-12)
        n = [torch.where(norm > 0, c / safe, 0.0) for c in n]
        v = [col(eye, c) - pt[c] for c in range(3)]          # to the camera = view
        flip = (n[0] * v[0] + n[1] * v[1] + n[2] * v[2]) < 0
        n = [torch.where(flip, -c, c) for c in n]

        # Phong (shader.py:78-113), the lights unrolled
        contrib = [0.0, 0.0, 0.0]
        for li in range(len(self._i_d)):
            ld = [col(dirs, li, c) for c in range(3)]
            ndotl = torch.clamp(ld[0] * n[0] + ld[1] * n[1] + ld[2] * n[2], min=0.0)
            r = [2.0 * ndotl * n[c] - ld[c] for c in range(3)]
            rdotv = r[0] * v[0] + r[1] * v[1] + r[2] * v[2]
            diffuse = self._k_diffuse * ndotl
            specular = self._k_specular * rdotv ** self._alpha
            for c in range(3):
                contrib[c] = (contrib[c] + diffuse * self._i_d[li][c]
                              + specular * self._i_s[li][c])
        dark = (self._max_depth - depth) * self._dark / self._thickness
        chans = []
        for c in range(3):
            illum = self._k_ambient * self._ambient + contrib[c]
            shaded = torch.clamp(self._bg[c] * illum, 0.0, 255.0)
            # the host pipeline's uint8 wrap of over-darkened pixels:
            # rint (half to even), then Python-sign modulo 256
            rounded = torch.round(shaded - dark).to(torch.int32)
            chans.append(torch.remainder(rounded, 256).to(torch.uint8))
        return torch.stack(chans, dim=-1)

    @torch.no_grad()
    def render_frames(self, depth_batch, m_invs, eyes, light_dirs):
        """(B, H, W) depths with per-frame (B, 4, 4) inverse view-projections,
        (B, 3) eyes and (B, 4, 3) light directions -> (B, H, W, 3) uint8.
        The math of ``__call__``, with nothing camera-dependent fixed. A depth
        tensor already on the renderer's device (``render_frames_packed``'s
        depth_clip) is used where it lies."""
        f32 = lambda a: as_device_tensor(a, torch.float32, self.device)  # noqa: E731
        return self._render(f32(depth_batch), f32(m_invs), f32(eyes), f32(light_dirs))

    @torch.no_grad()
    def __call__(self, depth_batch):
        """(B, H, W) normalised clipped depth buffers -> (B, H, W, 3) uint8,
        through the camera and lights fixed at construction."""
        f32 = lambda a: as_device_tensor(a, torch.float32, self.device)  # noqa: E731
        return self._render(f32(depth_batch), f32(self._m_inv[None]), f32(self._eye[None]),
                            f32(self._light_dirs[None]))
