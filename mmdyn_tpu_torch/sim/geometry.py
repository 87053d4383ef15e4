"""ROS-free pose algebra (the port's copy of ``mmdyn_tpu/sim/geometry.py``;
port of mmdyn/tact_sim/utils/geometry.py).

The reference vendors a 1.7k-line transformations library (Gohlke 2009) for a
handful of conversions; here everything routes through
scipy.spatial.transform. Quaternions are xyzw.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation

from mmdyn_tpu_torch.sim.transforms import quat_slerp


class Position:
    def __init__(self):
        self.x = 0.0
        self.y = 0.0
        self.z = 0.0


class Orientation:
    def __init__(self):
        self.x = 0.0
        self.y = 0.0
        self.z = 0.0
        self.w = 0.0


class Pose:
    def __init__(self, position, orientation):
        self.position = position
        self.orientation = orientation


class Header:
    def __init__(self):
        self.frame_id = "world"


class PoseStamped:
    def __init__(self):
        self.pose = Pose(Position(), Orientation())
        self.header = Header()

    def value(self):
        print("frame_id:    ", self.header.frame_id)
        print("position:    ", vars(self.pose.position))
        print("orientation: ", vars(self.pose.orientation))


def list2pose_stamped(pose, frame_id="world"):
    msg = PoseStamped()
    msg.header.frame_id = frame_id
    (msg.pose.position.x, msg.pose.position.y, msg.pose.position.z,
     msg.pose.orientation.x, msg.pose.orientation.y, msg.pose.orientation.z,
     msg.pose.orientation.w) = [float(v) for v in pose]
    return msg


def pose_stamped2list(msg):
    return [float(msg.pose.position.x), float(msg.pose.position.y),
            float(msg.pose.position.z), float(msg.pose.orientation.x),
            float(msg.pose.orientation.y), float(msg.pose.orientation.z),
            float(msg.pose.orientation.w)]


def unit_pose():
    return list2pose_stamped([0, 0, 0, 0, 0, 0, 1])


def matrix_from_pose(pose):
    """PoseStamped -> 4x4 homogeneous matrix (geometry.py:143-149)."""
    pose_list = pose_stamped2list(pose)
    t = np.eye(4)
    t[0:3, 0:3] = Rotation.from_quat(pose_list[3:7]).as_matrix()
    t[0:3, 3] = pose_list[0:3]
    return t


def pose_from_matrix(matrix, frame_id="world"):
    """4x4 matrix -> PoseStamped (geometry.py:80-85)."""
    trans = np.asarray(matrix)[0:3, 3]
    quat = Rotation.from_matrix(np.asarray(matrix)[0:3, 0:3]).as_quat()
    return list2pose_stamped(list(trans) + list(quat), frame_id=frame_id)


def get_transform(pose_frame_target, pose_frame_source):
    """Transform mapping source frame to target frame (geometry.py:129-141)."""
    t_target = matrix_from_pose(pose_frame_target)
    t_source = matrix_from_pose(pose_frame_source)
    t_rel = np.matmul(t_target, np.linalg.inv(t_source))
    return pose_from_matrix(t_rel, frame_id=pose_frame_source.header.frame_id)


def convert_reference_frame(pose_source, pose_frame_target, pose_frame_source,
                            frame_id="yumi_body"):
    """Express pose_source (in source frame) in the target frame
    (geometry.py:102-108)."""
    t_pose = matrix_from_pose(pose_source)
    transform = get_transform(pose_frame_source, pose_frame_target)
    t_out = np.matmul(matrix_from_pose(transform), t_pose)
    return pose_from_matrix(t_out, frame_id=frame_id)


def convert_reference_frame_list(pose_source_list, pose_frame_target,
                                 pose_frame_source, frame_id="yumi_body"):
    return [convert_reference_frame(p, pose_frame_target, pose_frame_source,
                                    frame_id) for p in pose_source_list]


def transform_pose(pose_source, pose_transform):
    """Left-multiply pose by a transform (geometry.py:253-258)."""
    t = np.matmul(matrix_from_pose(pose_transform), matrix_from_pose(pose_source))
    return pose_from_matrix(t, frame_id=pose_source.header.frame_id)


def transform_body(pose_source_world, pose_transform_target_body):
    """Apply a transform expressed in the body frame (geometry.py:260-274)."""
    pose_source_body = convert_reference_frame(
        pose_source_world, pose_source_world, unit_pose(), frame_id="body_frame")
    pose_rotated_body = transform_pose(pose_source_body,
                                       pose_transform_target_body)
    return convert_reference_frame(pose_rotated_body, unit_pose(),
                                   pose_source_world, frame_id="yumi_body")


def rotate_local_pose(pose_world, offset):
    """Rotate a pose about its own axes by euler offsets (geometry.py:276-284)."""
    rot = np.eye(4)
    rot[0:3, 0:3] = Rotation.from_euler("xyz", offset).as_matrix()
    return transform_body(pose_world, pose_from_matrix(rot, frame_id="tmp"))


def rotate_local_pose_list(pose_world_list, offset_list):
    return [rotate_local_pose(p, o) for p, o in zip(pose_world_list, offset_list)]


def offset_local_pose(pose_world, offset):
    """Translate a pose along its own axes (geometry.py:292-308)."""
    pose_local = convert_reference_frame(pose_world, pose_world, unit_pose(),
                                         frame_id="local")
    pose_local.pose.position.x += offset[0]
    pose_local.pose.position.y += offset[1]
    pose_local.pose.position.z += offset[2]
    return convert_reference_frame(pose_local, unit_pose(), pose_world,
                                   frame_id="world")


def interpolate_pose(pose_initial, pose_final, N, frac=1):
    """Linear position + slerp orientation interpolation (geometry.py:206-233)."""
    frame_id = pose_initial.header.frame_id
    pi = pose_stamped2list(pose_initial)
    pf = pose_stamped2list(pose_final)
    trans = [np.linspace(pi[i], pf[i], num=N) for i in range(3)]
    out = []
    for counter in range(int(frac * N)):
        quat = quat_slerp(pi[3:7], pf[3:7], counter / (N - 1))
        out.append(list2pose_stamped(
            [trans[0][counter], trans[1][counter], trans[2][counter],
             quat[0], quat[1], quat[2], quat[3]], frame_id=frame_id))
    return out


def get_2d_pose(pose3d):
    """(x, y, yaw) from a 3-D pose (geometry.py:42-50)."""
    t = matrix_from_pose(pose3d)
    yaw = Rotation.from_matrix(t[0:3, 0:3]).as_euler("xyz")[2]
    return np.array([pose3d.pose.position.x, pose3d.pose.position.y, yaw])


def C3_2d(theta):
    return np.array([[np.cos(theta), np.sin(theta)],
                     [-np.sin(theta), np.cos(theta)]])


def C3(theta):
    return np.array([[np.cos(theta), np.sin(theta), 0],
                     [-np.sin(theta), np.cos(theta), 0],
                     [0, 0, 1]])


def unwrap(angles, min_val=-np.pi, max_val=np.pi):
    angles = np.asarray(angles, dtype=np.float64)
    out = angles.copy()
    out[out < min_val] += 2 * np.pi
    out[out > max_val] -= 2 * np.pi
    return out
