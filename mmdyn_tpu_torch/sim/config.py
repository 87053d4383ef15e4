"""Simulator constants (the port's copy of ``mmdyn_tpu/sim/config.py``; port
of mmdyn/tact_sim/config.py). The object catalogs of that module (the
ShapeNet categories, the bundled objects) belong to ``sim/assets``, which
the port does not carry yet, and come with it."""

# Simulator parameters
TIME_STEP = 1.0 / 240.0
RENDERS = True
