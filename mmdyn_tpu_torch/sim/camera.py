"""OpenGL-convention camera (the port's copy of ``mmdyn_tpu/sim/camera.py``;
port of mmdyn/tact_sim/tactile/camera.py).

Implements the full forward/inverse pipeline
world <-> eye <-> clip <-> NDC <-> window and depth-buffer conversions with
the exact conventions of the reference (window z in [near, far], normalised
buffer z_b in [0, 1]). Differences by design:

* the view matrix (lookAt) is computed in numpy — no PyBullet dependency;
* ``project_pointcloud_to_canvas`` is fully vectorised (the reference scatters
  per-pixel in a Python loop, camera.py:128-135, its own TODO);
* rendering is delegated to a physics backend's ``render()`` rather than a
  hard p.getCameraImage call, so the camera works over PyBullet or the
  analytic engine.
"""

from __future__ import annotations

import math
import time
from pathlib import Path

import numpy as np


def look_at(eye, target, up):
    """OpenGL lookAt view matrix (row-major 4x4), camera looking down -z."""
    eye = np.asarray(eye, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    f = target - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    view = np.eye(4)
    view[0, :3] = s
    view[1, :3] = u
    view[2, :3] = -f
    view[0, 3] = -np.dot(s, eye)
    view[1, 3] = -np.dot(u, eye)
    view[2, 3] = np.dot(f, eye)
    return view


class Camera:
    """See module docstring. API mirrors the reference Camera."""

    def __init__(self, width, height, camera_up_vector=(0, 1, 0), backend=None):
        self._width = width
        self._height = height
        self._view_mat = None
        self._projection_mat = None
        self._near = None
        self._far = None
        self._fovy = None
        self._aspect = None
        self._camera_eye_pos = None
        self._camera_target_pos = None
        self._camera_up_vec = np.array(camera_up_vector)
        self._init_camera_up_vec = np.array(camera_up_vector)
        self._backend = backend

    def set_backend(self, backend):
        self._backend = backend

    # --- matrices -------------------------------------------------------

    def set_view_matrix(self, camera_eye_pos, camera_target_pos, camera_up_vec):
        """Row-major ModelView matrix (camera.py:38-56)."""
        self._camera_eye_pos = camera_eye_pos
        self._camera_target_pos = camera_target_pos
        self._camera_up_vec = camera_up_vec
        self._view_mat = look_at(camera_eye_pos, camera_target_pos, camera_up_vec)

    def set_projection_matrix(self, fovy, aspect, near, far):
        """Symmetric-frustum projection (camera.py:58-81)."""
        self._fovy = fovy
        self._aspect = aspect
        self._near = near
        self._far = far
        top = math.tan(math.radians(fovy / 2)) * near
        right = top * aspect
        self._projection_mat = np.array([
            [near / right, 0, 0, 0],
            [0, near / top, 0, 0],
            [0, 0, -(far + near) / (far - near), -2 * far * near / (far - near)],
            [0, 0, -1, 0],
        ])

    # --- forward pipeline -------------------------------------------------

    def project_3D_to_pixel(self, point):
        """World (3, N) -> window pixels [x_w; y_w; z_w] (camera.py:83-108)."""
        point = np.reshape(point, (3, -1))
        p = np.pad(point, ((0, 1), (0, 0)), mode="constant", constant_values=1)
        point_eye = np.matmul(self.view_matrix, p)
        point_clip = np.matmul(self.projection_matrix, point_eye)
        ndc_point = self.clip_to_ndc(point_clip)
        return self.ndc_to_window(ndc_point)

    def project_pointcloud_to_canvas(self, xyz, colors):
        """Pointcloud -> (rgb canvas, normalised depth canvas), vectorised
        z-buffer scatter (replaces the reference's per-pixel loop)."""
        pixels = self.project_3D_to_pixel(xyz)
        x_w = np.rint(pixels[0]).astype(np.int64)
        y_w = np.rint(pixels[1]).astype(np.int64)
        z_w = pixels[2]

        canvas_depth = np.ones((self._height, self._width))
        canvas_rgb = np.ones((self._height, self._width, 4))

        valid = (x_w >= 0) & (x_w < self._width) & (y_w >= 0) & (y_w < self._height)
        x_w, y_w, z_w = x_w[valid], y_w[valid], z_w[valid]
        cols = colors[:, valid]
        # nearest point wins: sort far-to-near so the final write is nearest
        order = np.argsort(-z_w)
        x_w, y_w, z_w = x_w[order], y_w[order], z_w[order]
        cols = cols[:, order]
        canvas_depth[y_w, x_w] = z_w
        canvas_rgb[y_w, x_w, :] = cols.T
        return canvas_rgb.astype(np.uint8), self.normalize_depth(canvas_depth)

    # --- inverse pipeline -------------------------------------------------

    def unproject_pixel_to_3D(self, pixel):
        """Window pixels [x_w; y_w; z_w] (3, N) -> world (camera.py:154-177)."""
        pixel_ndc = self.window_to_ndc(np.reshape(pixel, (3, -1)))
        p = np.pad(pixel_ndc, ((0, 1), (0, 0)), mode="constant",
                   constant_values=1.0)
        m_inv = np.linalg.inv(np.matmul(self.projection_matrix, self.view_matrix))
        point = np.matmul(m_inv, p)
        return self.clip_to_world(point)

    def unproject_canvas_to_pointcloud(self, rgb_img, depth_img):
        """Full canvas + normalised depth buffer -> (points (3,N), colors (4,N))
        (camera.py:179-211), vectorised."""
        depth_img = self.denormalize_depth(np.asarray(depth_img))
        x = np.linspace(0, self._width - 1, self._width)
        y = np.linspace(0, self._height - 1, self._height)
        x_mesh, y_mesh = np.meshgrid(x, y)
        canvas = np.stack([x_mesh.reshape(-1), y_mesh.reshape(-1),
                           np.asarray(depth_img).reshape(-1)])
        colors = np.asarray(rgb_img).transpose(2, 0, 1).reshape(rgb_img.shape[2], -1)
        return self.unproject_pixel_to_3D(canvas), colors

    # --- coordinate conversions -------------------------------------------

    def clip_to_ndc(self, point):
        return point[:3] / point[-1]

    def clip_to_world(self, point):
        return point[:3] / point[-1]

    def ndc_to_window(self, point):
        """x,y: [-1,1] -> [0,w]x[0,h]; z: [-1,1] -> [near,far]
        (camera.py:242-265)."""
        scale = np.array([[self._width / 2],
                          [self._height / 2],
                          [(self._far - self._near) / 2]])
        offset = np.array([[self._width / 2],
                           [self._height / 2],
                           [(self._far + self._near) / 2]])
        return scale * point + offset

    def window_to_ndc(self, pixel):
        scale = np.array([[2.0 / self._width],
                          [2.0 / self._height],
                          [2.0 / (self._far - self._near)]])
        offset = np.array([[-1.0],
                           [-1.0],
                           [-(self._far + self._near) / (self._far - self._near)]])
        return scale * pixel + offset

    def depth_buffer_to_real(self, z_b):
        """Normalised buffer z_b -> eye-space depth z_e (camera.py:289-304)."""
        return 2 * self._far * self._near / (
            self._far + self._near - (self._far - self._near) * (2 * z_b - 1))

    def real_depth_to_buffer(self, z_e):
        """Eye-space depth z_e -> normalised buffer z_b (camera.py:306-320)."""
        a = self._projection_mat[2, 2]
        b = self._projection_mat[2, 3]
        return 0.5 * (-a + b / z_e) + 0.5

    def normalize_depth(self, z_w):
        return (z_w - self._near) / (self._far - self._near)

    def denormalize_depth(self, z_b):
        return (self._far - self._near) * z_b + self._near

    # --- rendering ----------------------------------------------------------

    def get_image(self):
        """Render via the attached backend -> (rgb, depth buffer, seg)."""
        assert self._backend is not None, "camera has no render backend"
        return self._backend.render(self)

    # reference-compatible alias (camera.py:352-364)
    get_pybullet_image = get_image

    def get_raytraced_image(self):
        """Raytraced (rgb, depth, normals, seg). A TODO stub in the reference
        (camera.py:366-373); delivered here by the analytic raycaster.
        Requires a backend whose render() supports return_normals (the
        AnalyticBackend does; Bullet's OpenGL path does not)."""
        assert self._backend is not None, "camera has no render backend"
        rgb, depth, seg, normals = self._backend.render(self,
                                                        return_normals=True)
        return rgb, depth, normals, seg

    # --- IO -----------------------------------------------------------------

    def show_image(self, img, RGB=True, save=False, title="Image"):
        import cv2
        img = np.reshape(np.asarray(img), (self._height, self._width, -1))
        time_str = time.strftime("%Y%m%d-%H%M%S")
        if RGB:
            cv2.imshow(title, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
            if save:
                cv2.imwrite(title + "_" + time_str + ".png",
                            cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        else:
            cv2.imshow(title, img)
            if save:
                cv2.imwrite(title + "_" + time_str + ".png", img)
        cv2.waitKey(1)

    def save_image(self, img, path, title="Image", RGB=True, time_stamp=False):
        """PNG write (camera.py:396-416): RGB images as-is; non-RGB (depth/
        seg) scaled by 255 and cast to uint8."""
        import cv2
        img = np.reshape(np.asarray(img), (self._height, self._width, -1))
        Path(path).mkdir(parents=True, exist_ok=True)
        if time_stamp:
            title = title + "_" + time.strftime("%Y%m%d-%H%M%S")
        filename = Path(path).joinpath(title + ".png")
        if RGB:
            img3 = img[:, :, :3].astype(np.uint8)
            cv2.imwrite(str(filename), cv2.cvtColor(img3, cv2.COLOR_RGB2BGR))
        else:
            cv2.imwrite(str(filename), (img * 255).astype(np.uint8))

    # --- properties -----------------------------------------------------------

    @property
    def width(self):
        return self._width

    @property
    def height(self):
        return self._height

    @property
    def view_matrix(self):
        return self._view_mat

    @property
    def projection_matrix(self):
        return self._projection_mat

    @property
    def near(self):
        return self._near

    @property
    def far(self):
        return self._far

    @property
    def fovy(self):
        return self._fovy

    @property
    def aspect(self):
        return self._aspect

    @property
    def camera_up_vector(self):
        return np.array(self._camera_up_vec)

    @property
    def init_camera_up_vector(self):
        return np.array(self._init_camera_up_vec)

    @property
    def camera_eye_position(self):
        return np.array(self._camera_eye_pos)

    @property
    def camera_target_position(self):
        return np.array(self._camera_target_pos)
