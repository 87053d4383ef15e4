"""Visuotactile STS simulator of the port (``mmdyn_tpu/sim/`` in PyTorch).

* host scene code, numpy copies of the JAX package's modules: ``config``,
  ``transforms``, ``camera`` (OpenGL-convention pipeline), ``shader``
  (Phong), ``normals``, ``utils``, ``contact``, ``physics``
  (``AnalyticBackend``: rigid bodies + a raycast renderer; ``PyBulletBackend``
  imports pybullet lazily) and ``sensor`` (``TactileSensor``,
  ``make_sensor``);
* device code, batched PyTorch on an explicit device: ``physics_torch``
  (``SimulatorTorch``: K trials x T steps of ``AnalyticBackend.step``),
  ``raycast_torch`` (``RaycastTorch``: visual RGB, depth and segmentation
  frames) and ``tactile_torch`` (``TactileRendererTorch``: tactile frames
  from the clipped depth).
"""

from mmdyn_tpu_torch.sim import config  # noqa: F401
