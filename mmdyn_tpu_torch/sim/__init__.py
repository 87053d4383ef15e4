"""Visuotactile STS simulator of the port (``mmdyn_tpu/sim/`` in PyTorch).

* host scene code, numpy copies of the JAX package's modules: ``config``,
  ``transforms``, ``camera`` (OpenGL-convention pipeline), ``shader``
  (Phong), ``normals``, ``utils``, ``contact``, ``physics``
  (``AnalyticBackend``: rigid bodies + a raycast renderer; ``PyBulletBackend``
  imports pybullet lazily), ``sensor`` (``TactileSensor``,
  ``make_sensor``), ``geometry`` (pose algebra), ``sample`` (pose
  sampling), ``meshio`` (OBJ / MTL parsing), ``assets`` (the bundled
  meshes, ShapeNet catalogs, the synthetic primitive catalog,
  ``spawn_object``), ``ros_camera`` (pinhole / stereo models) and
  ``pybullet_utils`` (PyBullet scene helpers);
* device code, batched PyTorch on an explicit device: ``physics_torch``
  (``SimulatorTorch``: K trials x T steps of ``AnalyticBackend.step``),
  ``raycast_torch`` (``RaycastTorch``: visual RGB, depth and segmentation
  frames) and ``tactile_torch`` (``TactileRendererTorch``: tactile frames
  from the clipped depth).
"""

from mmdyn_tpu_torch.sim import config  # noqa: F401
