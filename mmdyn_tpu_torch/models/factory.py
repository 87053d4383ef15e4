"""Model factory (port of ``mmdyn_tpu/models/factory.py``; reference
mmdyn/pytorch/models/models.py:13-25)."""

from __future__ import annotations

import torch

from mmdyn_tpu_torch import config
from mmdyn_tpu_torch.models.layers import torch_default_init_
from mmdyn_tpu_torch.models.vae import MVAE
from mmdyn_tpu_torch.utils.device import resolve_device


def setup_model(model_name, cross_modal=False, device=None, seed=0, **kwargs):
    """name -> initialised model on ``device`` (the card unless told otherwise).

    Weights take torch's default init from a CPU generator seeded with
    ``seed``, so one seed gives the same weights on every device. Of the
    families only the cross-modal cnn-mvae in float32 is ported; the others,
    the conditional model and the bf16 policies raise NotImplementedError.
    """
    if model_name not in config.MODELS:
        raise ValueError(f"Model {model_name!r} is not implemented")
    device = resolve_device(device)
    if not ("mvae" in model_name and cross_modal):
        raise NotImplementedError(
            f"{model_name} (cross_modal={cross_modal}) is not ported yet")
    if kwargs.pop("conditional", False):
        raise NotImplementedError("the conditional MVAE is not ported yet")
    dtype = kwargs.pop("compute_dtype", "float32")
    if dtype != "float32":
        raise NotImplementedError(f"compute_dtype {dtype!r} is not ported yet")
    model = MVAE(**kwargs)
    torch_default_init_(model, torch.Generator().manual_seed(seed))
    return model.to(device)


def count_parameters(model) -> int:
    """Total trainable parameter count."""
    return sum(p.numel() for p in model.parameters())
