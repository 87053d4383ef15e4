"""Phong reflection shader (the port's copy of ``mmdyn_tpu/sim/shader.py``;
port of mmdyn/tact_sim/tactile/shader.py).

Pure vectorised numpy over (3, N) point/normal arrays; ``illumination_torch``
is the illumination on tensors, on whatever device they lie.
"""

from __future__ import annotations

import math

import numpy as np


class Light:
    """A light source: position, direction, per-channel specular/diffuse
    intensities (shader.py:5-37)."""

    def __init__(self, position, direction, i_specular, i_diffuse):
        self._position = position
        self._direction = direction
        self._i_specular = i_specular
        self._i_diffuse = i_diffuse

    @property
    def position(self):
        return np.reshape(self._position, (3, 1))

    @property
    def direction(self):
        return np.reshape(self._direction, (3, 1))

    @property
    def i_specular(self):
        return np.reshape(self._i_specular, (3, 1))

    @property
    def i_diffuse(self):
        return np.reshape(self._i_diffuse, (3, 1))


class Shader:
    """Phong: I = k_a*i_a + sum_lights(k_d*(L.N)*i_d + k_s*(R.V)^alpha*i_s)
    (shader.py:40-129)."""

    def __init__(self, k_specular=0.15, k_diffuse=0.5, k_ambient=1, alpha=5,
                 ambient_lightning=1, directional_light=True, dtype=np.float64):
        """``dtype=np.float32`` shades faster (sub-uint8 differences at
        contact edges); float64 matches the reference exactly."""
        self._directional_light = directional_light
        self._k_specular = k_specular
        self._k_diffuse = k_diffuse
        self._k_ambient = k_ambient
        self._alpha = alpha
        self._ambient_lightning = ambient_lightning
        self._dtype = dtype
        self._lights = []

    def set_lights(self, positions, directions, i_speculars, i_diffuses):
        assert len(positions) == len(i_speculars) == len(i_diffuses), \
            "All properties must have the same length."
        self._lights = [Light(p, d, s, f) for p, d, s, f in
                        zip(positions, directions, i_speculars, i_diffuses)]

    def illumination(self, points, surface_normals, viewer):
        """Per-point RGB illumination (3, N) (shader.py:78-113)."""
        points = np.reshape(points, (3, -1)).astype(self._dtype, copy=False)
        surface_normals = np.reshape(surface_normals, (3, -1)).astype(
            self._dtype, copy=False)
        viewer = np.reshape(viewer, (3, -1)).astype(self._dtype, copy=False)

        i_p = self._k_ambient * self._ambient_lightning
        for light in self._lights:
            v = viewer - points
            l = (light.direction if self._directional_light
                 else light.position - points).astype(self._dtype, copy=False)
            # clip back-facing contributions (shader.py:104-106)
            ndotl = np.clip(np.sum(l * surface_normals, axis=0), 0, math.inf)
            r = 2 * ndotl * surface_normals - l
            i_p = i_p + (self._k_diffuse * ndotl * light.i_diffuse
                         + self._k_specular * (np.sum(r * v, axis=0) ** self._alpha)
                         * light.i_specular)
        return i_p

    def shade_image(self, rgb_img, illumination):
        """Multiply RGB by per-pixel illumination, clip to [0, 255]
        (shader.py:115-129)."""
        height, width = rgb_img.shape[0], rgb_img.shape[1]
        illumination = illumination.transpose().reshape(height, width, -1)
        return np.clip(rgb_img[:, :, :3] * illumination, 0, 255)

    @property
    def lights(self):
        return self._lights


def illumination_torch(points, normals, viewer, light_dirs, i_diffuses,
                       i_speculars, k_diffuse, k_specular, k_ambient,
                       ambient, alpha):
    """Batched torch version of Shader.illumination (directional lights),
    computed where the tensors lie.

    Args:
        points, normals: (3, N); viewer: (3, 1); light_dirs: (L, 3, 1);
        i_diffuses/i_speculars: (L, 3, 1).
    Returns (3, N) illumination.
    """
    v = viewer - points                                          # (3, N)
    ndotl = (light_dirs * normals[None]).sum(dim=1).clamp(min=0.0)   # (L, N)
    r = 2 * ndotl[:, None, :] * normals[None] - light_dirs      # (L, 3, N)
    rdotv = (r * v[None]).sum(dim=1)                             # (L, N)
    contrib = (k_diffuse * ndotl[:, None, :] * i_diffuses
               + k_specular * (rdotv ** alpha)[:, None, :] * i_speculars)
    return k_ambient * ambient + contrib.sum(dim=0)
