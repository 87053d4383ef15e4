"""Device resolution and numeric settings for the port's entry points."""

from __future__ import annotations

import functools

import numpy as np
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


def same_device(a: torch.device, b: torch.device) -> bool:
    """Whether ``a`` and ``b`` name one device: a card without an index
    (``cuda``, as ``resolve_device`` gives it) is the current card, where
    its tensors lie (``cuda:0``)."""
    if a.type != b.type:
        return False

    def index(d):
        return torch.cuda.current_device() if d.type == "cuda" and d.index is None else d.index

    return index(a) == index(b)


def as_device_tensor(a, dtype, device) -> torch.Tensor:
    """``a`` as a ``dtype`` tensor on ``device``: numpy is uploaded; a tensor
    on another device is refused rather than moved, so work meant for the
    card never runs elsewhere unasked."""
    if isinstance(a, torch.Tensor):
        if not same_device(a.device, device):
            raise ValueError(f"a tensor on {a.device} given to a module on {device}")
        return a.to(dtype)
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


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


def cudnn_deterministic(fn, device):
    """``fn`` as a training ``Problem`` calls it on ``device``: on a card, each
    call runs with cuDNN's deterministic algorithms (the setting before the
    call is restored after it); elsewhere ``fn`` itself.

    A step must rerun bit for bit from one state, as the JAX package's
    does, or a resumed run drifts from the uninterrupted one. In float32
    cuDNN's default algorithms for the convolutions' data and weight
    gradients, and for the decoders' transposed-convolution forwards (a data
    gradient in cuDNN's terms), sum in an order that changes from call to
    call; those passes, and the convolutions' forwards and the transposed
    convolutions' data gradients, are the port's own kernels
    (``models/layers.py::_ConvF32``: ``conv_wgrad_f32``, ``conv_dgrad_f32``,
    ``conv_fprop_f32``), which sum in a fixed order. What cuDNN still runs
    (the bias gradients) runs its deterministic algorithms under this
    setting. The
    bf16 policies' default algorithms rerun bit for bit already, and there
    the setting costs nothing. The backward runs inside the call, so the
    setting covers it. The unwrapped function is ``__wrapped__``.
    """
    if torch.device(device).type != "cuda":
        return fn

    @functools.wraps(fn)
    def call(*args, **kwargs):
        before = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            return fn(*args, **kwargs)
        finally:
            torch.backends.cudnn.deterministic = before

    return call
