"""Device resolution, weights carried over from the JAX package, and the
run-length wire of the simulator's dumps (``wire``)."""

from mmdyn_tpu_torch.utils.device import resolve_device
from mmdyn_tpu_torch.utils.weights import params_from_jax
