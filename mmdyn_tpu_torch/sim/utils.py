"""Image / pointcloud / video utilities (the port's copy of
``mmdyn_tpu/sim/utils.py``; port of mmdyn/tact_sim/tactile/utils.py).

``PointCloud`` drops the Open3D dependency: grid-structured clouds (the only
kind the sensor produces) get exact central-difference normals; unstructured
clouds fall back to kNN-PCA (see normals.py).
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np

from mmdyn_tpu_torch.sim.normals import grid_normals, knn_pca_normals


def normalize(v):
    """Unit-normalise a vector; zero vectors pass through (utils.py:8-12)."""
    norm = np.linalg.norm(v)
    if norm == 0:
        return v
    return v / norm


class Video:
    """cv2 XVID video writer (utils.py:15-50)."""

    def __init__(self, width=640, height=480, RGB=True, file_name="video_output",
                 logdir="."):
        import cv2
        self._cv2 = cv2
        self._RGB = RGB
        time_str = time.strftime("%Y%m%d-%H%M%S")
        fourcc = cv2.VideoWriter_fourcc(*"XVID")
        video_name = Path(logdir).joinpath(file_name + time_str + ".avi")
        self._video = cv2.VideoWriter(str(video_name), fourcc, 20.0,
                                      (width, height))

    def write(self, frame):
        if self._RGB:
            self._video.write(self._cv2.cvtColor(frame, self._cv2.COLOR_RGB2BGR))
        else:
            self._video.write(frame)

    def close(self):
        self._video.release()
        self._cv2.destroyAllWindows()


class PointCloud:
    """Pointcloud with colors and estimated normals (utils.py:53-118)."""

    def __init__(self):
        self._points = np.zeros((3, 0))
        self._colors = np.zeros((3, 0))
        self._normals = np.zeros((3, 0))

    def set_points(self, points, colors=None, estimate_normals=False,
                   camera_location=(0, 0, 0), grid_shape=None, **kwargs):
        """Set (3, N) points / colors; optionally estimate oriented normals.

        ``grid_shape=(H, W)`` marks the cloud as canvas-ordered, enabling the
        exact O(N) gradient normals. Colors are stored normalised to [0, 1]
        like open3d (utils.py:73).
        """
        self._points = np.asarray(points).reshape(3, -1)
        if colors is not None:
            self._colors = np.asarray(colors)[:3, :] / 255.0
        if estimate_normals:
            self.estimate_normals(camera_location=camera_location,
                                  grid_shape=grid_shape, **kwargs)

    def estimate_normals(self, camera_location, grid_shape=None, **kwargs):
        if self._points.shape[1] == 0:
            return
        if grid_shape is not None:
            self._normals = grid_normals(self._points, grid_shape,
                                         camera_location)
        else:
            self._normals = knn_pca_normals(self._points,
                                            camera_location=camera_location)

    def show(self):
        """3-D scatter preview via matplotlib (open3d viewer replacement)."""
        if self._points.shape[1] == 0:
            return
        import matplotlib.pyplot as plt
        fig = plt.figure()
        ax = fig.add_subplot(projection="3d")
        step = max(1, self._points.shape[1] // 5000)
        p = self._points[:, ::step]
        c = self._colors[:, ::step].T if self._colors.size else None
        ax.scatter(p[0], p[1], p[2], c=c, s=1)
        plt.show()

    @property
    def points(self):
        return self._points

    @property
    def colors(self):
        return self._colors

    @property
    def normals(self):
        return self._normals


class ImageBuffer:
    """Ring buffer of rgb/depth/seg/z/t frames with nearest-query retrieval
    (utils.py:121-231).

    Parity quirk (deliberate, see docs/PARITY.md): the reference allocates the
    segmentation buffer as **uint8** (utils.py:129), so the clipped
    "no object" value -1 wraps to **255** in every frame retrieved from the
    buffer — force-mode equilibrium images therefore carry 255, not -1, in
    clipped pixels. We replicate that by default; pass ``seg_dtype=np.int32``
    to keep signed ids (e.g. scenes with >254 bodies). Two reference bugs are
    NOT replicated: its ``reset()`` reallocates with the current fill count
    instead of the capacity (utils.py:196-201), which shrinks the buffer and
    crashes the next ``store`` after an early-fill reset; and values are
    silently truncated rather than range-checked.
    """

    def __init__(self, img_width, img_height, size, n_channel=3,
                 seg_dtype=np.uint8):
        self.img_width, self.img_height, self.n_channel = (img_width,
                                                           img_height, n_channel)
        self.max_size = size
        self.seg_dtype = np.dtype(seg_dtype)
        self.reset()

    def store(self, rgb_img, depth_img, seg_img, obj_z, t):
        self.rgb_buf[self.ptr] = np.asarray(rgb_img)[:, :, :self.n_channel].reshape(-1)
        self.depth_buf[self.ptr] = np.asarray(depth_img).reshape(-1)
        # uint8 default wraps -1 -> 255, matching the reference (utils.py:129)
        self.seg_buf[self.ptr] = np.asarray(seg_img).reshape(-1).astype(
            self.seg_dtype, copy=False)
        self.z_buf[self.ptr] = obj_z
        self.t_buf[self.ptr] = t
        self.ptr = (self.ptr + 1) % self.max_size
        self.size = min(self.size + 1, self.max_size)

    def get(self, s=None, body_id=None, query="idx"):
        idx = self.ptr - 1
        if s is not None:
            if query == "z":
                idx = int(np.abs(self.z_buf - s).argmin())
            elif query == "time":
                idx = int(np.abs(self.t_buf - s).argmin())
            else:
                idx = min(int(s), self.ptr - 1)
        return {
            "rgb_img": self.rgb_buf[idx].reshape(
                (self.img_height, self.img_width, self.n_channel)),
            "depth_img": self.depth_buf[idx].reshape(
                (self.img_height, self.img_width)),
            "seg_img": self.seg_buf[idx].reshape(
                (self.img_height, self.img_width)),
            "z": self.z_buf[idx],
            "t": self.t_buf[idx],
        }

    def reset(self):
        n = self.img_width * self.img_height
        self.rgb_buf = np.zeros((self.max_size, n * self.n_channel), np.uint8)
        self.depth_buf = np.zeros((self.max_size, n), np.float32)
        self.seg_buf = np.zeros((self.max_size, n), self.seg_dtype)
        self.z_buf = np.zeros(self.max_size, np.float32)
        self.t_buf = np.zeros(self.max_size, np.float32)
        self.ptr, self.size = 0, 0

    @property
    def min_z(self):
        return float(np.min(self.z_buf[:self.ptr - 1])) if self.ptr > 1 else 0.0

    @property
    def max_z(self):
        return float(np.max(self.z_buf[:self.ptr - 1])) if self.ptr > 1 else 0.0

    @property
    def min_t(self):
        return float(np.min(self.t_buf[:self.ptr - 1])) if self.ptr > 1 else 0.0

    @property
    def max_t(self):
        return float(np.max(self.t_buf[:self.ptr - 1])) if self.ptr > 1 else 0.0

    @property
    def pointer(self):
        return self.ptr
