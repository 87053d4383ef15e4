"""Pose / position sampling (the port's copy of ``mmdyn_tpu/sim/sample.py``;
port of mmdyn/tact_sim/utils/sample.py).

The draws come from the global ``random`` and ``np.random`` in the JAX
package's order: the CLIs' per-trial seeds rely on it.
"""

from __future__ import annotations

import math
import random

import numpy as np

from mmdyn_tpu_torch.sim.transforms import (apply_rotation, apply_transformation,
                                      get_rotation_matrix,
                                      get_transformation_matrix,
                                      quat_from_euler)
from mmdyn_tpu_torch.sim.utils import normalize


def sample_pose(mean_position, random_chance=0.5, gaussian_mean=0.0,
                gaussian_std=0.1, random_orn=False, random_yaw=False):
    """Randomised object pose: Gaussian xy-jitter + (uniform quaternion |
    random yaw | identity) orientation (sample.py:60-93)."""
    position = np.array(mean_position) + np.random.normal(
        gaussian_mean, gaussian_std, size=3)
    position[-1] = mean_position[-1]

    if random_yaw:
        orientation = quat_from_euler([0.0, 0.0, random.random() * 2 * math.pi])
    elif random_orn:
        if random.random() < random_chance:
            # uniform quaternion (Shoemake)
            x = np.random.random(size=3)
            orientation = [
                math.sqrt(1 - x[0]) * math.sin(2 * math.pi * x[1]),
                math.sqrt(1 - x[0]) * math.cos(2 * math.pi * x[1]),
                math.sqrt(x[0]) * math.sin(2 * math.pi * x[2]),
                math.sqrt(x[0]) * math.cos(2 * math.pi * x[2]),
            ]
        else:
            orientation = [0, 0, 0, 1]
    else:
        orientation = quat_from_euler([0, 0, 0])
    return np.array(position), np.array(orientation)


def sample_positions(mean_position, n_objects, orientation=(0, 0, 0, 1),
                     gaussian_mean=0.0, gaussian_std=0.1):
    """Gaussian-jittered positions for multiple objects (sample.py:96-115)."""
    positions, orientations = [], []
    for _ in range(n_objects):
        p = np.array(mean_position) + np.random.normal(gaussian_mean,
                                                       gaussian_std, size=3)
        p[-1] = mean_position[-1]
        positions.append(p)
        orientations.append(orientation)
    return positions, orientations


def sample_point_on_mesh(mesh, base_position=(0, 0, 0),
                         base_orientation=(0, 0, 0, 1), scale=1):
    """Sample a surface point + local frame from a mesh (sample.py:12-57).

    Accepts a first-party meshio.Mesh (or any object exposing vertices/faces
    with sample_surface()/face_normals()); trimesh meshes also work when
    trimesh is installed."""
    if isinstance(scale, list):
        scale = scale[0]

    transformation_mat = get_transformation_matrix(translation=base_position,
                                                   rotation=base_orientation)
    rotation_mat = get_rotation_matrix(rotation=base_orientation)

    from mmdyn_tpu_torch.sim.meshio import Mesh as _MeshIO
    if isinstance(mesh, _MeshIO):
        point, face_idx = mesh.sample_surface(1)
        tri_points = mesh.vertices[mesh.faces[face_idx]]
        normal = mesh.face_normals()[face_idx]
    else:
        import trimesh
        if isinstance(mesh, trimesh.Scene):
            mesh = mesh.dump().sum()
        point, face_idx = trimesh.sample.sample_surface(mesh, count=1)
        tri_points = mesh.vertices[mesh.faces[face_idx]]
        normal = mesh.face_normals[face_idx]

    point = scale * point
    tri_points = (scale * tri_points).squeeze()

    point = apply_transformation(point, transformation_mat).squeeze()
    tri_points = apply_transformation(tri_points, transformation_mat).squeeze()
    normal = apply_rotation(normal, rotation_mat).squeeze()

    v_1 = normalize(normal)
    v_2 = normalize(tri_points[1, :] - tri_points[0, :])
    v_3 = normalize(np.cross(v_1, v_2))

    rot_mat = np.stack((v_1, v_2, v_3), axis=-1)
    rot_mat = np.pad(rot_mat, ((0, 1), (0, 1)), mode="constant",
                     constant_values=0)
    rot_mat[3, 3] = 1
    return point, normal, rot_mat
