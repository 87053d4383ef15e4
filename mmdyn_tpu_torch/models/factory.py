"""Model factory (port of ``mmdyn_tpu/models/factory.py``; reference
mmdyn/pytorch/models/models.py:13-25)."""

from __future__ import annotations

import torch

from mmdyn_tpu_torch import config
from mmdyn_tpu_torch.models.layers import check_policy, torch_default_init_
from mmdyn_tpu_torch.models.regressor import Regressor
from mmdyn_tpu_torch.models.vae import MVAE, VAE
from mmdyn_tpu_torch.utils.device import resolve_device


def setup_model(model_name, cross_modal=False, device=None, seed=0, **kwargs):
    """name -> initialised model on ``device`` (the card unless told otherwise).

    The families branch as in the JAX package: an MVAE for an "mvae" name on
    cross-modal input, a VAE for any other "vae" name (``use_pose`` dropped,
    as the reference VAE ignores it), else the regressor. ``kwargs`` are the
    JAX modules' fields. Weights take torch's default init from a CPU
    generator seeded with ``seed``, so one seed gives the same weights on
    every device. ``compute_dtype`` is one of ``float32``, ``bfloat16``
    and ``bfloat16_full`` (``models/layers.py``); the parameters are float32
    under all three.
    """
    if model_name not in config.MODELS:
        raise ValueError(f"Model {model_name!r} is not implemented")
    device = resolve_device(device)
    check_policy(kwargs.setdefault("compute_dtype", "float32"))
    if "mvae" in model_name and cross_modal:
        model = MVAE(**kwargs)
    elif "vae" in model_name:
        if cross_modal:
            raise ValueError("VAE does not work with cross modal inputs.")
        kwargs.pop("use_pose", None)
        model = VAE(**kwargs)
    else:
        model = Regressor(**kwargs)
    torch_default_init_(model, torch.Generator().manual_seed(seed))
    return model.to(device)


def model_kwargs(cfg) -> dict:
    """``setup_model`` arguments for a ``ProblemConfig``, as a training run
    derives them (``mmdyn_tpu/train/loop.py::_build_model``): the regressor
    predicts the 7-D pose; the VAEs take 64*64 inputs (problems.py:372), which
    only the MLP variant reads."""
    if cfg.problem_type == "regression":
        return dict(out_dim=7, conditional=cfg.conditional,
                    condition_dim=cfg.condition_dim, compute_dtype=cfg.compute_dtype)
    kw = dict(latent_size=cfg.latent_size, architecture=cfg.model_name.split("-")[0],
              conditional=cfg.conditional,
              categorical_conditions=cfg.categorical_conditions,
              condition_dim=cfg.condition_dim, compute_dtype=cfg.compute_dtype)
    if cfg.is_mvae:
        kw["use_pose"] = cfg.use_pose
    else:
        kw["input_dim"] = 64 * 64
    return kw


def count_parameters(model) -> int:
    """Total trainable parameter count."""
    return sum(p.numel() for p in model.parameters())
