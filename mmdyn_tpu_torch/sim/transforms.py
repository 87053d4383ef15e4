"""Quaternion / matrix helpers (the port's copy of ``mmdyn_tpu/sim/transforms.py``;
port of mmdyn/tact_sim/utils/transforms.py), using scipy.spatial.transform
instead of PyBullet bindings.

Quaternions are xyzw throughout (PyBullet/ROS convention, which scipy shares).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation


def quat_to_matrix(quaternion):
    """(x, y, z, w) -> 3x3 rotation matrix (pybullet getMatrixFromQuaternion)."""
    return Rotation.from_quat(np.asarray(quaternion, dtype=np.float64)).as_matrix()


def quat_from_euler(euler):
    """XYZ-intrinsic? PyBullet getQuaternionFromEuler uses fixed-axis XYZ
    (extrinsic), equal to scipy 'xyz' lowercase."""
    return Rotation.from_euler("xyz", np.asarray(euler, dtype=np.float64)).as_quat()


def euler_from_quat(quaternion):
    return Rotation.from_quat(np.asarray(quaternion, dtype=np.float64)).as_euler("xyz")


def quat_slerp(q0, q1, fraction):
    """Spherical interpolation between two xyzw quaternions."""
    from scipy.spatial.transform import Slerp
    r = Rotation.from_quat(np.stack([np.asarray(q0, np.float64),
                                     np.asarray(q1, np.float64)]))
    return Slerp([0.0, 1.0], r)([float(fraction)]).as_quat()[0]


def get_transformation_matrix(translation, rotation):
    """4x4 homogeneous transform from translation + xyzw quaternion
    (transforms.py:6-25)."""
    t = np.zeros((4, 4))
    t[0:3, 0:3] = quat_to_matrix(rotation)
    t[0:3, 3] = np.asarray(translation).reshape(3)
    t[3, 3] = 1.0
    return t


def get_rotation_matrix(rotation):
    """3x3 rotation matrix from an xyzw quaternion (transforms.py:28-39)."""
    return quat_to_matrix(rotation)


def apply_transformation(points, transformation_mat):
    """Apply a 4x4 transform to (N, 3) points (transforms.py:42-57)."""
    points = np.asarray(points).transpose()
    points = np.pad(points, ((0, 1), (0, 0)), mode="constant", constant_values=1)
    points = np.matmul(transformation_mat, points)
    return points[:3, :].transpose()


def apply_rotation(points, rotation_mat):
    """Apply a 3x3 rotation to (N, 3) points (transforms.py:60-73)."""
    return np.matmul(rotation_mat, np.asarray(points).transpose()).transpose()
