"""Device resolution and numeric settings for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: raise when there is none rather than run on
    the CPU unasked. Any explicit device (``"cpu"`` in the tests) is taken
    as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def device_for_platform(platform) -> torch.device:
    """The CLIs' ``--platform``: ``cpu`` selects the CPU; anything else, or
    nothing, the card (raising without one)."""
    return resolve_device("cpu" if platform == "cpu" else None)


def set_reference_precision() -> None:
    """Arithmetic as the parity checks hold it, for every policy.

    * float32 convolutions and matmuls in full float32: torch runs cuDNN
      convolutions in TF32 by default, which keeps about three decimal
      digits. Under the bf16 policies this covers what stays float32 (the
      PoE backward's matmuls, for one).
    * bf16 matmuls accumulate in float32 throughout, as the JAX package's
      ``jnp.dot`` does: with reduced-precision reduction allowed, cuBLAS may
      round split-K partial sums to bf16.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
