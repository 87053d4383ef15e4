"""STS sensor emulation (the port's copy of ``mmdyn_tpu/sim/sensor.py``; port
of mmdyn/tact_sim/tactile/sensor.py) over the physics-backend seam.

``Sensor``: rigid body with an integrated camera whose view matrix tracks the
body pose. ``TactileSensor``: clips depth to the gel layer, repaints RGB to
the sensor background colour, clips segmentation, optionally force-matches
penetration against an image-buffer history, and Phong-shades the unprojected
pointcloud into a tactile image with penetration darkening.

The tactile shading path (unproject -> grid normals -> Phong -> darken) is
fully vectorised here and batched on a device by ``sim/tactile_torch.py``;
the grid-normal estimation replaces Open3D's kNN (sensor.py:383-413 +
tactile/utils.py:77-88) with exact central differences, O(N).
"""

from __future__ import annotations

import math
import random

import numpy as np

from mmdyn_tpu_torch.sim import config
from mmdyn_tpu_torch.sim.camera import Camera
from mmdyn_tpu_torch.sim.contact import Contact
from mmdyn_tpu_torch.sim.shader import Shader
from mmdyn_tpu_torch.sim.transforms import quat_from_euler, euler_from_quat, quat_to_matrix
from mmdyn_tpu_torch.sim.utils import ImageBuffer, PointCloud, normalize


class Sensor:
    """Sensor rigid body with an integrated camera (sensor.py:16-256)."""

    def __init__(self, backend, position, orientation, mesh_scale,
                 sensor_vector, mass=10000, camera_up_vector=(0, 1, 0),
                 image_width=640, image_height=480, camera_fovy=60,
                 camera_aspect=1, camera_near=0.01, camera_far=1,
                 simple_model=True, constrained=False, virtual_links=False,
                 color=(1.0, 157 / 255, 0.0)):
        self.backend = backend
        self._position = np.array(position, dtype=np.float64)
        self._orientation = np.array(orientation, dtype=np.float64)
        self._sensor_size = np.array(mesh_scale) if simple_model else np.array([1.6, 1.6, 0.5])
        self._init_sensor_vector = sensor_vector
        self._time = 0.0
        self._virtual_links = virtual_links
        self._constrained = constrained
        self._max_force = 10000
        self.prev_cmd = [0, 0, 0, 0, 0, 0]

        self._sensor_id = self._create_body(position, orientation, mesh_scale,
                                            mass, color, simple_model)

        # fixed constraint holding the sensor (sensor.py:58-67), PyBullet-only
        self._sensor_constraint = None
        if constrained:
            from mmdyn_tpu_torch.sim.physics import PyBulletBackend
            if isinstance(backend, PyBulletBackend):
                p = backend.pybullet
                self._sensor_constraint = p.createConstraint(
                    parentBodyUniqueId=self._sensor_id, parentLinkIndex=-1,
                    childBodyUniqueId=-1, childLinkIndex=-1,
                    jointType=p.JOINT_FIXED, jointAxis=[0, 0, 0],
                    parentFramePosition=[0, 0, 0],
                    childFramePosition=[0, 0, 0],
                    childFrameOrientation=[0, 0, 0])

        self._camera = Camera(width=image_width, height=image_height,
                              camera_up_vector=camera_up_vector,
                              backend=backend)
        self._camera.set_projection_matrix(fovy=camera_fovy,
                                           aspect=camera_aspect,
                                           near=camera_near, far=camera_far)

        # debug lines (sensor.py:84-86, PyBullet only)
        self.debug_line = []
        from mmdyn_tpu_torch.sim.physics import PyBulletBackend as _PB
        if isinstance(backend, _PB):
            p = backend.pybullet
            self.debug_line = [p.addUserDebugLine([0.0, 0.0, 0.0],
                                                  [1.0, 0.0, 0.0], [1, 0, 0])
                               for _ in range(5)]

        # surface normal vector and spanning vectors (sensor.py:76-81)
        surface_vectors = [0 if x == 1 else 1 for x in sensor_vector]
        self._init_surface_vec_1 = np.zeros(3)
        self._init_surface_vec_2 = np.zeros(3)
        self._init_surface_vec_1[np.nonzero(surface_vectors)[0][0]] = 1
        self._init_surface_vec_2[np.nonzero(surface_vectors)[0][1]] = 1
        self._sensor_vector = np.array([])
        self._surface_vec_1 = np.array([])
        self._surface_vec_2 = np.array([])

    def _create_body(self, position, orientation, mesh_scale, mass, color,
                     simple_model):
        from mmdyn_tpu_torch.sim.physics import PyBulletBackend
        if isinstance(self.backend, PyBulletBackend):
            from mmdyn_tpu_torch.sim.pybullet_utils import add_object
            model = "cube.obj"  # simple_model path (sensor.py:48-49, :531)
            return add_object(self.backend, graphic_file=model,
                              collision_file=model, base_position=position,
                              base_orientation=orientation,
                              mesh_scale=mesh_scale, mass=mass,
                              color=[x for x in color] + [1.0],
                              virtual_links=self._virtual_links)
        # analytic: a box with half-extents = size/2 (cube.obj is a unit cube
        # scaled by mesh_scale); heavy sensors are pinned, light ones (the
        # force-perturbation scenario, exp_3 mass=100) stay dynamic
        return self.backend.add_box(
            half_extents=np.asarray(mesh_scale, np.float64) / 2,
            position=position, orientation=orientation, mass=mass,
            color=color, fixed=mass >= 1000)

    # --- pose tracking ------------------------------------------------------

    def _update_pose(self):
        pos, orn = self.backend.get_pose(self._sensor_id)
        self._time += self.backend.time_step if hasattr(self.backend, "time_step") else config.TIME_STEP
        self._position = np.array(pos)
        self._orientation = np.array(orn)

    def set_pose(self, position, orientation, quaternion=True):
        if not quaternion:
            orientation = quat_from_euler(orientation)
        self.backend.set_pose(self._sensor_id, position, orientation)

    def _update_sensor(self):
        """Recompute facing/spanning vectors + camera view matrix
        (sensor.py:109-127)."""
        rot = quat_to_matrix(self._orientation)
        self._sensor_vector = normalize(rot.dot(self._init_sensor_vector))
        self._surface_vec_1 = normalize(rot.dot(self._init_surface_vec_1))
        self._surface_vec_2 = normalize(rot.dot(self._init_surface_vec_2))
        camera_up = normalize(rot.dot(self._camera.init_camera_up_vector))
        eye = (self._position - self._sensor_vector
               * abs(np.dot(self._init_sensor_vector, self._sensor_size)) / 2)
        # facing-direction debug line (sensor.py:121-123, PyBullet GUI only)
        if self.debug_line:
            self.backend.pybullet.addUserDebugLine(
                eye, self._position + self._sensor_vector, [1, 0, 0],
                replaceItemUniqueId=self.debug_line[0])
        self._camera.set_view_matrix(eye, self._position + self._sensor_vector,
                                     camera_up)

    # --- control ------------------------------------------------------------

    def get_command(self, controller):
        """Read GUI slider commands (sensor.py:129-138, PyBullet GUI only)."""
        return [self.backend.pybullet.readUserDebugParameter(c)
                for c in controller]

    def plan_motion(self, speed=40):
        """Random motion planner (sensor.py:140-154)."""
        rand = random.random()
        if rand < 0.3:
            cmd = [0, 0, speed / 5, 0, 0, 0]
        else:
            cmd = [random.uniform(-speed, speed), random.uniform(-speed, speed),
                   0, 0, 0, 0]
        self.prev_cmd = cmd
        return cmd

    def apply_command(self, cmd, velocity=True, local_coord=True):
        """Velocity / position commands (sensor.py:156-204). The virtual-link
        joint-motor variant is PyBullet-only."""
        from mmdyn_tpu_torch.sim.physics import PyBulletBackend
        if self._virtual_links and isinstance(self.backend, PyBulletBackend):
            p = self.backend.pybullet
            for j in range(p.getNumJoints(self._sensor_id)):
                if velocity:
                    p.setJointMotorControl2(self._sensor_id, j,
                                            p.VELOCITY_CONTROL,
                                            targetPosition=0,
                                            targetVelocity=cmd[j],
                                            velocityGain=1.0,
                                            force=self._max_force)
                else:
                    p.setJointMotorControl2(self._sensor_id, j,
                                            p.POSITION_CONTROL,
                                            targetPosition=cmd[j],
                                            targetVelocity=0,
                                            positionGain=1, velocityGain=1,
                                            force=self._max_force)
            return

        if velocity:
            dt = getattr(self.backend, "time_step", config.TIME_STEP)
            delta_position = np.array(cmd[0:3]) * dt
            delta_orientation = np.array(cmd[3:6]) * dt
            base_position, base_orientation = self.backend.get_pose(self._sensor_id)
            if local_coord:
                rot = quat_to_matrix(base_orientation)
                new_position = rot.dot(delta_position) + np.array(base_position)
            else:
                new_position = delta_position + np.array(base_position)
            new_orientation = quat_from_euler(
                euler_from_quat(base_orientation) + delta_orientation)
        else:
            assert not local_coord, \
                "Position controller only works with global coordinates."
            new_position = cmd[0:3]
            new_orientation = quat_from_euler(cmd[3:6])
        if self._constrained and self._sensor_constraint is not None:
            self.backend.pybullet.changeConstraint(
                self._sensor_constraint, new_position, new_orientation,
                maxForce=self._max_force)
        else:
            self.backend.set_pose(self._sensor_id, new_position,
                                  new_orientation)

    # --- sensing ------------------------------------------------------------

    def get_sensor_image(self):
        """(rgb, depth buffer, seg) from the tracked camera (sensor.py:206-216)."""
        self._update_pose()
        self._update_sensor()
        return self._camera.get_image()

    def get_sensor_pointcloud(self, rgb_img=None, depth_img=None):
        if rgb_img is None or depth_img is None:
            rgb_img, depth_img, _ = self.get_sensor_image()
        points, colors = self._camera.unproject_canvas_to_pointcloud(rgb_img,
                                                                     depth_img)
        pcd = PointCloud()
        pcd.set_points(points, colors, estimate_normals=True,
                       camera_location=self._position,
                       grid_shape=(self._camera.height, self._camera.width))
        return pcd

    @property
    def position(self):
        return self._position

    @property
    def orientation(self):
        return self._orientation

    @property
    def sensor_size(self):
        return self._sensor_size

    @property
    def sensor_id(self):
        return self._sensor_id

    @property
    def camera(self):
        return self._camera


class TactileSensor(Sensor):
    """STS emulation (sensor.py:259-491)."""

    def __init__(self, shader, layer_thickness=0.005, buffer_size=200,
                 solver_epsilon=1, k_spring=1, darkening_factor=10,
                 use_force=False, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._shader = shader
        self._layer_thickness = layer_thickness
        self._image_buf = ImageBuffer(self.camera.width, self.camera.height,
                                      buffer_size, n_channel=3)
        self._solver_epsilon = solver_epsilon
        self._k_spring = k_spring
        self._darkening_factor = darkening_factor
        self._use_force = use_force

        # background colour matched to the real sensor (sensor.py:289)
        self.background_color = np.array([178, 178, 204, 255])
        # depth beyond the gel layer is outside the sensing region
        # (sensor.py:292-294)
        self.max_buffer_depth = self.camera.real_depth_to_buffer(
            self._layer_thickness
            + abs(np.dot(self._init_sensor_vector, self._sensor_size)))
        self._contacts = None

    def _set_lights(self, i_specular=2.0, i_diffuse=2.0):
        """Four coloured edge lights: R, G, B, white (sensor.py:298-340)."""
        z = self._sensor_vector * (self._sensor_size / 2)
        positions = [
            self._position + self._surface_vec_1 * self._sensor_size + z,
            self._position - self._surface_vec_1 * self._sensor_size + z,
            self._position + self._surface_vec_2 * self._sensor_size + z,
            self._position - self._surface_vec_2 * self._sensor_size + z,
        ]
        directions = [-self._surface_vec_1, self._surface_vec_1,
                      -self._surface_vec_2, self._surface_vec_2]
        i_speculars = [[i_specular, 0, 0], [0, i_specular, 0],
                       [0, 0, i_specular], [i_specular] * 3]
        i_diffuses = [[i_diffuse, 0, 0], [0, i_diffuse, 0],
                      [0, 0, i_diffuse], [i_diffuse] * 3]
        self._shader.set_lights(positions=positions, directions=directions,
                                i_speculars=i_speculars, i_diffuses=i_diffuses)

    def get_sensor_image(self):
        """(raw rgb, clipped rgb, clipped depth, raw seg, clipped seg)
        (sensor.py:342-381)."""
        self._update_pose()
        self._update_sensor()
        rgb_img, depth_img, seg_img = self._camera.get_image()
        rgb_img = np.asarray(rgb_img)
        depth_img = np.array(depth_img, dtype=np.float64, copy=True)
        seg_img = np.asarray(seg_img)

        self.refresh_contacts()

        mask = np.where(depth_img >= self.max_buffer_depth)
        depth_img[mask] = self.max_buffer_depth

        clipped_rgb_img = np.copy(rgb_img)
        clipped_rgb_img[:, :, :] = self.background_color

        clipped_seg_img = np.array(seg_img, copy=True)
        clipped_seg_img[mask] = -1

        if self._use_force:
            obj_id = self.backend.last_body_id()
            position, _ = self.backend.get_pose(obj_id)
            self._image_buf.store(clipped_rgb_img, depth_img, clipped_seg_img,
                                  position[-1], self._time)
            eq = self.compute_equilibrium()
            return rgb_img, eq["rgb_img"], eq["depth_img"], seg_img, eq["seg_img"]
        return rgb_img, clipped_rgb_img, depth_img, seg_img, clipped_seg_img

    def get_sensor_pointcloud(self, rgb_img=None, depth_img=None, mask=False):
        """Pointcloud of the clipped sensor image (sensor.py:383-413)."""
        if rgb_img is None or depth_img is None:
            _, rgb_img, depth_img, _, _ = self.get_sensor_image()
        points, colors = self._camera.unproject_canvas_to_pointcloud(rgb_img,
                                                                     depth_img)
        grid_shape = (self._camera.height, self._camera.width)
        if mask:
            keep = np.where(points[-1, :] < self.layer_thickness
                            + self.camera.camera_eye_position[-1]
                            + self.sensor_size[-1] / 2)
            points = points[:, keep].squeeze()
            colors = colors[:, keep].squeeze()
            grid_shape = None  # no longer grid-ordered
        pcd = PointCloud()
        pcd.set_points(points, colors, estimate_normals=True,
                       camera_location=self._position, grid_shape=grid_shape)
        return pcd

    def get_tactile_image(self, rgb_img, depth_img, pointcloud, i_specular=2.0,
                          i_diffuse=2.0):
        """Phong-shade the clipped image + darken by penetration
        (sensor.py:415-445), under the reference's lights by default."""
        self._set_lights(i_specular=i_specular, i_diffuse=i_diffuse)
        illumination = self._shader.illumination(
            pointcloud.points, pointcloud.normals,
            self._camera.camera_eye_position)
        tactile_img = self._shader.shade_image(np.asarray(rgb_img), illumination)

        dark_map = self.max_buffer_depth - np.asarray(depth_img)
        dark_map = np.repeat(dark_map[:, :, np.newaxis], 3, axis=2)
        tactile_img = tactile_img - self._darkening_factor * dark_map / self._layer_thickness

        alpha = 255 * np.ones((self.camera.height, self.camera.width, 1))
        tactile_img = np.concatenate((tactile_img, alpha), axis=2)
        # the reference casts np.rint(...) straight to uint8 (sensor.py:443),
        # so over-darkened negative pixels wrap modulo 256; replicate that
        # deterministically via an int64 modulo
        return (np.rint(tactile_img).astype(np.int64) % 256).astype(np.uint8)

    def refresh_contacts(self):
        """Recreate the contact snapshot get_sensor_image captures; exposed so
        a deferred (device-rendered) snapshot path can take the same contact
        reading without running the host raycast."""
        self._contacts = Contact(self._sensor_id, self.backend)
        return self._contacts

    def compute_equilibrium(self):
        """Binary-search the image buffer for the frame whose spring force
        sum k*(depth deficit) matches the contact normal force
        (sensor.py:447-474)."""
        l, r = 0, self._image_buf.pointer
        img = self._image_buf.get(l)
        for body in self._contacts.unique_ids:
            contact_force = self._contacts.total_force(body)
            while l <= r:
                m = int(round((l + r) / 2))
                img = self._image_buf.get(m, query="idx")
                spring_force = np.sum(self._k_spring *
                                      (self.max_buffer_depth - img["depth_img"]))
                if abs(spring_force - contact_force) < self._solver_epsilon:
                    return img
                elif spring_force > contact_force:
                    r = m - 1
                else:
                    l = m + 1
        return img

    def reset(self):
        self._image_buf.reset()
        self._update_pose()
        self._update_sensor()

    def is_blank(self, seg_img):
        """True when nothing is in the sensing region (sensor.py:482-483)."""
        return bool(np.all(np.asarray(seg_img) == -1))

    @property
    def layer_thickness(self):
        return self._layer_thickness

    @property
    def contacts(self):
        return self._contacts


def make_sensor(backend, position=(0.0, 0.0, 0.5), orientation=(0, 0, 0, 1),
                size=(1.0, 1.0, 1.0), mass=10000, sensor_vector=(0.0, 0.0, 1.0),
                thickness=0.01, use_force=False, constrained=False,
                virtual_links=False, fast_shading=False):
    """Shader + camera intrinsics + TactileSensor factory (sensor.py:494-537).
    ``fast_shading`` switches Phong to float32 (faster data generation,
    sub-uint8 image differences)."""
    import numpy as _np
    shader = Shader(k_specular=0.5, k_diffuse=1.0, k_ambient=0.8, alpha=5,
                    ambient_lightning=1.0, directional_light=True,
                    dtype=_np.float32 if fast_shading else _np.float64)
    near = abs(np.dot(size, sensor_vector)) * 0.9
    far = 10
    fovy = 2 * math.atan(size[0] / 2 / abs(np.dot(size, sensor_vector))) / math.pi * 180
    return TactileSensor(
        shader,
        layer_thickness=thickness,
        buffer_size=200,
        solver_epsilon=1.0,
        k_spring=1.0,
        darkening_factor=1,
        backend=backend,
        position=position,
        orientation=orientation,
        mesh_scale=size,
        mass=mass,
        sensor_vector=sensor_vector,
        camera_up_vector=[0.0, 1.0, 0.0],
        image_width=640,
        image_height=480,
        camera_fovy=fovy,
        camera_aspect=1,
        camera_near=near,
        camera_far=far,
        simple_model=True,
        use_force=use_force,
        constrained=constrained,
        virtual_links=virtual_links,
    )
