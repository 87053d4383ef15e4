"""Device resolution and weights carried over from the JAX package."""

from mmdyn_tpu_torch.utils.device import resolve_device
from mmdyn_tpu_torch.utils.weights import params_from_jax
