"""ROS-style pinhole / stereo camera models (the port's copy of
``mmdyn_tpu/sim/ros_camera.py``; port of
mmdyn/tact_sim/tactile/ros_camera.py, itself adapted from ros-perception
image_geometry; rewritten with plain numpy arrays instead of the deprecated
np.matrix).

Standalone alternative to the OpenGL-convention Camera, useful for real-sensor
calibration work (K/D/R/P intrinsics, rectification, 3D<->pixel,
disparity<->depth).
"""

from __future__ import annotations

import math

import numpy as np


def mkmat(rows, cols, values):
    return np.asarray(values, dtype="float64").reshape(rows, cols)


class ROI:
    """Region of interest; all zeros means full resolution."""

    def __init__(self, width=0, height=0, x_offset=0, y_offset=0):
        self._width = width
        self._height = height
        self._x_offset = x_offset
        self._y_offset = y_offset

    @property
    def width(self):
        return self._width

    @property
    def height(self):
        return self._height

    @property
    def x_offset(self):
        return self._x_offset

    @property
    def y_offset(self):
        return self._y_offset


class ROSPinholeCameraModel:
    """Idealized monocular pinhole camera (ros_camera.py:48-299)."""

    def __init__(self):
        self._K = None
        self._D = None
        self._R = None
        self._P = None
        self._full_K = None
        self._full_P = None
        self._width = None
        self._height = None
        self._binning_x = None
        self._binning_y = None
        self._raw_roi = None
        self._resolution = None
        self._map_x = None
        self._map_y = None

    def from_camera_params(self, k, r, p, width, height, d=None, binning_x=1,
                           binning_y=1, roi=None):
        """Configure from ROS CameraInfo-style parameters, adjusting K and P
        for binning + ROI."""
        self._K = mkmat(3, 3, k)
        self._D = mkmat(len(d), 1, d) if d else None
        self._R = mkmat(3, 3, r)
        self._P = mkmat(3, 4, p)
        self._full_K = mkmat(3, 3, k)
        self._full_P = mkmat(3, 4, p)
        self._width = width
        self._height = height
        self._binning_x = max(1, binning_x)
        self._binning_y = max(1, binning_y)
        self._resolution = (width, height)
        self._raw_roi = roi if roi is not None else ROI()
        self._map_x = None
        self._map_y = None

        self._K[0, 0] /= self._binning_x
        self._K[1, 1] /= self._binning_y
        self._K[0, 2] = (self._K[0, 2] - self._raw_roi.x_offset) / self._binning_x
        self._K[1, 2] = (self._K[1, 2] - self._raw_roi.y_offset) / self._binning_y
        self._P[0, 0] /= self._binning_x
        self._P[1, 1] /= self._binning_y
        self._P[0, 2] = (self._P[0, 2] - self._raw_roi.x_offset) / self._binning_x
        self._P[1, 2] = (self._P[1, 2] - self._raw_roi.y_offset) / self._binning_y

    def rectify_image(self, raw):
        """Undistort + rectify an image using (K, D, R, P)."""
        import cv2
        self._map_x, self._map_y = cv2.initUndistortRectifyMap(
            self._K, self._D, self._R, self._P,
            (self._width, self._height), cv2.CV_32FC1)
        return cv2.remap(raw, self._map_x, self._map_y, cv2.INTER_CUBIC)

    def rectify_point(self, uv_raw):
        """Rectify a single (u, v) pixel."""
        import cv2
        src = np.asarray(uv_raw, dtype="float64").reshape(1, 1, 2)
        dst = cv2.undistortPoints(src, self._K, self._D, R=self._R, P=self._P)
        return dst[0, 0]

    def project_3D_to_pixel(self, point):
        """3D point -> rectified (u, v) via P; inverse of
        project_pixel_to_3DRay."""
        src = mkmat(4, 1, [point[0], point[1], point[2], 1.0])
        dst = self._P @ src
        x, y, w = dst[0, 0], dst[1, 0], dst[2, 0]
        if w != 0:
            return x / w, y / w
        return float("nan"), float("nan")

    def project_pixel_to_3DRay(self, uv):
        """Rectified (u, v) -> unit ray through the camera center."""
        x = (uv[0] - self.cx) / self.fx
        y = (uv[1] - self.cy) / self.fy
        norm = math.sqrt(x * x + y * y + 1)
        return x / norm, y / norm, 1.0 / norm

    def get_delta_u(self, deltaX, Z):
        if Z == 0:
            return float("inf")
        return self.fx * deltaX / Z

    def get_delta_v(self, deltaY, Z):
        if Z == 0:
            return float("inf")
        return self.fy * deltaY / Z

    def get_delta_x(self, deltaU, Z):
        return Z * deltaU / self.fx

    def get_delta_y(self, deltaV, Z):
        return Z * deltaV / self.fy

    @property
    def full_resolution(self):
        return self._resolution

    @property
    def intrinsic_matrix(self):
        return self._K

    @property
    def distortion_coeffs(self):
        return self._D

    @property
    def rotation_matrix(self):
        return self._R

    @property
    def projection_matrix(self):
        return self._P

    @property
    def full_intrinsic_matrix(self):
        return self._full_K

    @property
    def full_projection_matrix(self):
        return self._full_P

    @property
    def cx(self):
        return self._P[0, 2]

    @property
    def cy(self):
        return self._P[1, 2]

    @property
    def fx(self):
        return self._P[0, 0]

    @property
    def fy(self):
        return self._P[1, 1]

    @property
    def Tx(self):
        return self._P[0, 3]

    @property
    def Ty(self):
        return self._P[1, 3]

    @property
    def width(self):
        return self._width

    @property
    def height(self):
        return self._height


class ROSStereoCameraModel:
    """Idealized stereo pair (ros_camera.py:302-414)."""

    def __init__(self):
        self.left_cam = ROSPinholeCameraModel()
        self.right_cam = ROSPinholeCameraModel()
        self.Q = None

    def from_camera_params(self, left_cam_params, right_cam_params):
        self.left_cam.from_camera_params(**left_cam_params)
        self.right_cam.from_camera_params(**right_cam_params)

        fx = self.right_cam.projection_matrix[0, 0]
        cx = self.right_cam.projection_matrix[0, 2]
        cy = self.right_cam.projection_matrix[1, 2]
        tx = -self.right_cam.projection_matrix[0, 3] / fx

        # reprojection matrix Q (disparity -> depth)
        self.Q = np.zeros((4, 4), dtype="float64")
        self.Q[0, 0] = 1.0
        self.Q[0, 3] = -cx
        self.Q[1, 1] = 1.0
        self.Q[1, 3] = -cy
        self.Q[2, 3] = fx
        self.Q[3, 2] = 1 / tx

    def project_3D_to_pixel(self, point):
        """3D point -> ((u_l, v_l), (u_r, v_r))."""
        return (self.left_cam.project_3D_to_pixel(point),
                self.right_cam.project_3D_to_pixel(point))

    def project_pixel_to_3D(self, left_uv, disparity):
        """(u, v) + disparity -> 3D point; zero disparity means infinity."""
        src = mkmat(4, 1, [left_uv[0], left_uv[1], disparity, 1.0])
        dst = self.Q @ src
        x, y, z, w = dst[0, 0], dst[1, 0], dst[2, 0], dst[3, 0]
        if w != 0:
            return x / w, y / w, z / w
        return 0.0, 0.0, 0.0

    def get_z(self, disparity):
        """Depth from disparity; inverse of get_disparity."""
        if disparity == 0:
            return float("inf")
        tx = -self.right_cam.projection_matrix[0, 3]
        return tx / disparity

    def get_disparity(self, Z):
        """Disparity from depth; inverse of get_z."""
        if Z == 0:
            return float("inf")
        tx = -self.right_cam.projection_matrix[0, 3]
        return tx / Z
