"""PyBullet scene helpers (the port's copy of
``mmdyn_tpu/sim/pybullet_utils.py``; port of mmdyn/tact_sim/utils/pybullet.py).

Only used with the PyBulletBackend; every function takes the backend so no
global pybullet module state leaks into the rest of the framework.
"""

from __future__ import annotations

import math


def setup_pybullet(time_step=1.0 / 240, load_plane=True, gravity=True,
                   plane_urdf="plane100.urdf", renders=True):
    """Connect + configure Bullet; returns a PyBulletBackend
    (pybullet.py:8-37)."""
    from mmdyn_tpu_torch.sim.physics import PyBulletBackend
    return PyBulletBackend(time_step=time_step, renders=renders,
                           load_plane=load_plane, gravity=gravity,
                           plane_urdf=plane_urdf)


def add_object(backend, graphic_file="duck.obj", collision_file="duck_vhacd.obj",
               texture_file=(), mass=1, base_position=(0.0, 0.0, 0.0),
               base_orientation=(0.0, 0.0, 0.0, 1.0), mesh_scale=(1, 1, 1),
               COM_shift=(0, 0.0, 0), color=(), diagonal_inertial=None,
               virtual_links=False, constrained=False):
    """Textured mesh body, optionally with 6 virtual prismatic/revolute links
    for base motion control (pybullet.py:40-155)."""
    p = backend.pybullet
    visual_id = p.createVisualShape(shapeType=p.GEOM_MESH,
                                    fileName=str(graphic_file),
                                    rgbaColor=[1, 1, 1, 1],
                                    specularColor=[0.4, 0.4, 0],
                                    visualFramePosition=[0, 0, 0],
                                    meshScale=mesh_scale)
    collision_id = p.createCollisionShape(shapeType=p.GEOM_MESH,
                                          fileName=str(collision_file),
                                          collisionFramePosition=[0, 0, 0],
                                          meshScale=mesh_scale)

    if virtual_links:
        n_links = 6
        obj_id = p.createMultiBody(
            baseMass=mass,
            baseInertialFramePosition=COM_shift,
            baseInertialFrameOrientation=[0, 0, 0, 1],
            baseCollisionShapeIndex=collision_id,
            baseVisualShapeIndex=visual_id,
            basePosition=base_position,
            baseOrientation=base_orientation,
            linkMasses=[0.001] * n_links,
            linkCollisionShapeIndices=[-1] * n_links,
            linkVisualShapeIndices=[-1] * n_links,
            linkPositions=[[0, 0, 0]] * n_links,
            linkOrientations=[[0, 0, 0, 1]] * n_links,
            linkInertialFramePositions=[[0, 0, 0]] * n_links,
            linkInertialFrameOrientations=[[0, 0, 0, 1]] * n_links,
            linkParentIndices=[0, 1, 2, 3, 4, 5],
            linkJointTypes=[p.JOINT_PRISMATIC] * 3 + [p.JOINT_REVOLUTE] * 3,
            linkJointAxis=[[1, 0, 0], [0, 1, 0], [0, 0, 1],
                           [1, 0, 0], [0, 1, 0], [0, 0, 1]],
            useMaximalCoordinates=False)
        for i in range(n_links):
            p.changeDynamics(bodyUniqueId=obj_id, linkIndex=i,
                             jointDamping=0.1, jointLowerLimit=-100,
                             jointUpperLimit=100,
                             localInertiaDiagonal=[0.001, 0.001, 0.001])
    else:
        obj_id = p.createMultiBody(baseMass=mass,
                                   baseInertialFramePosition=COM_shift,
                                   baseInertialFrameOrientation=[0, 0, 0, 1],
                                   baseCollisionShapeIndex=collision_id,
                                   baseVisualShapeIndex=visual_id,
                                   basePosition=base_position,
                                   baseOrientation=base_orientation,
                                   useMaximalCoordinates=False)

    if texture_file:
        texture_id = p.loadTexture(textureFilename=str(texture_file))
        p.changeVisualShape(objectUniqueId=obj_id, linkIndex=-1,
                            textureUniqueId=texture_id)
    if color:
        p.changeVisualShape(objectUniqueId=obj_id, linkIndex=-1,
                            rgbaColor=color)
    if diagonal_inertial:
        assert isinstance(diagonal_inertial, list)
        p.changeDynamics(bodyUniqueId=obj_id, linkIndex=-1,
                         localInertiaDiagonal=diagonal_inertial)

    if constrained:
        constraint_id = p.createConstraint(parentBodyUniqueId=obj_id,
                                           parentLinkIndex=-1,
                                           childBodyUniqueId=-1,
                                           childLinkIndex=-1,
                                           jointType=p.JOINT_FIXED,
                                           jointAxis=[0, 0, 0],
                                           parentFramePosition=[0, 0, 0],
                                           childFramePosition=[0, 0, 0],
                                           childFrameOrientation=[0, 0, 0])
        return obj_id, constraint_id
    return obj_id


def add_objects(backend, graphic_files, collision_files, texture_files, masses,
                base_positions, base_orientations, mesh_scales, COM_shifts):
    """Bulk add with mesh-load skip on error (pybullet.py:158-189)."""
    assert (len(graphic_files) == len(collision_files) == len(texture_files)
            == len(base_positions) == len(base_orientations)
            == len(mesh_scales) == len(COM_shifts)), \
        "All lists must have the same number of elements."
    obj_id = []
    p = backend.pybullet
    for args in zip(graphic_files, collision_files, texture_files, masses,
                    base_positions, base_orientations, mesh_scales, COM_shifts):
        try:
            obj_id.append(add_object(backend, *args))
        except p.error:
            print("Cannot load the mesh, will skip this one.")
    return obj_id


def remove_objects(backend, obj_id):
    """Remove object(s) (pybullet.py:192-202)."""
    if isinstance(obj_id, list):
        for oid in obj_id:
            backend.remove_body(oid)
    else:
        backend.remove_body(obj_id)


def create_gui_controller(backend, velocity=False, amp=1):
    """Debug sliders for sensor tele-op (pybullet.py:205-223)."""
    p = backend.pybullet
    motor_ids = []
    for param in ["posX", "posY", "posZ"]:
        motor_ids.append(p.addUserDebugParameter(param, -amp, amp, 0))
    for param in ["rotX", "rotY", "rotZ"]:
        if velocity:
            motor_ids.append(p.addUserDebugParameter(param, -amp, amp, 0))
        else:
            motor_ids.append(p.addUserDebugParameter(param, -math.pi, math.pi, 0))
    return motor_ids


def fix_object(backend, obj_id, constraint_id, max_force=100000):
    """Re-pin a constraint-fixed object each step (pybullet.py:226-239)."""
    p = backend.pybullet
    pos, orn = p.getBasePositionAndOrientation(obj_id)
    p.changeConstraint(constraint_id, pos, orn, maxForce=max_force)
