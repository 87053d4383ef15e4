"""Device resolution, weights carried over from the JAX package, the
run-length wire of the simulator's dumps (``wire``), and the progress bar
and pickle IO (``training``)."""

from mmdyn_tpu_torch.utils.device import resolve_device
from mmdyn_tpu_torch.utils.training import format_time, load_pkl, progress_bar, save_pkl
from mmdyn_tpu_torch.utils.weights import params_from_jax
