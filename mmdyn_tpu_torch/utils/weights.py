"""Weights carried over from the JAX package's flax parameters (the port's
own copy of the layout rules of ``mmdyn_tpu/utils/torch_compat.py``).

``params_from_jax(model_name, params)`` takes a flax params tree as numpy
arrays and returns a ``state_dict`` that the port's model loads with
``strict=True``. The port names its parameters as the reference's torch
``state_dict`` does, so the rules are those of the reference export:

* conv kernels: flax (kh, kw, in, out) -> torch (out, in, kh, kw);
* transposed-conv kernels: flax stores the correlated orientation, so
  torch_w[i, o, a, b] = flax[kh-1-a, kw-1-b, i, o] (a spatial flip);
* the encoder FC reads, and the decoder ``upsample`` writes, the 5x5x256
  bottleneck flattened NHWC in flax and NCHW here: rows / columns (and the
  upsample bias) are permuted;
* BatchNorm: scale / bias -> weight / bias; the port keeps no running stats;
* a conditional model's heads and ``upsample`` take the condition's columns
  after the features, on both sides, so the same rules carry them.

The tree decides the layout: a VAE's ``encoder`` / ``decoder`` (cnn-vae,
mlp-vae, and an mvae name on single-modality input, which the factory builds
as a VAE), the regressor's trunk at the top with ``out_0..2`` as
``out_net.0/2/4``, else the MVAE's modality pairs.

The rules are linear maps, so they carry gradients as well as weights.

``bn_stats_from_jax(model_name, bn_stats)`` carries a JAX ``bn_stats``
collection (a frozen-BatchNorm serving session's statistics) by the same
BatchNorm name map, as ``models/layers.py::load_bn_stats`` takes it.
``from_reference_state_dict`` reads a reference-format ``state_dict`` (the
names are already the port's) by dropping the BatchNorm running buffers that
the reference writes and the port does not keep.
"""

from __future__ import annotations

import numpy as np
import torch

_ENC_CONV = [("conv_0", "conv_net.0"), ("conv_1", "conv_net.2"),
             ("conv_2", "conv_net.5"), ("conv_3", "conv_net.8")]
_ENC_BN = [("bn_1", "conv_net.3"), ("bn_2", "conv_net.6"), ("bn_3", "conv_net.9")]
_DEC_DECONV = [("deconv_0", "hallucinate.0"), ("deconv_1", "hallucinate.3"),
               ("deconv_2", "hallucinate.6"), ("deconv_3", "hallucinate.9")]
_DEC_BN = [("bn_0", "hallucinate.1"), ("bn_1", "hallucinate.4"),
           ("bn_2", "hallucinate.7")]


def _nhwc_to_nchw_perm(h=5, w=5, c=256):
    """NCHW-flat position -> NHWC-flat position of the bottleneck."""
    return np.arange(h * w * c).reshape(h, w, c).transpose(2, 0, 1).reshape(-1)


def _bn(out, prefix, p):
    out[prefix + ".weight"] = p["scale"]
    out[prefix + ".bias"] = p["bias"]


def _linear(out, name, p):
    out[name + ".weight"] = np.asarray(p["kernel"]).T
    out[name + ".bias"] = p["bias"]


def _mlp(out, prefix, p):
    j = 0
    while f"linear_{j}" in p:
        _linear(out, f"{prefix}.{2 * j}", p[f"linear_{j}"])
        j += 1


def _conv_trunk(out, p, prefix):
    """The DCGAN trunk and its FC 6400 -> 512, shared by encoder and regressor."""
    for fl, th in _ENC_CONV:
        out[prefix + th + ".weight"] = np.asarray(p[fl]["kernel"]).transpose(3, 2, 0, 1)
    for fl, th in _ENC_BN:
        _bn(out, prefix + th, p[fl])
    out[prefix + "fc_net.0.weight"] = np.asarray(p["fc"]["kernel"])[_nhwc_to_nchw_perm()].T
    out[prefix + "fc_net.0.bias"] = p["fc"]["bias"]


def _encoder(p, prefix):
    out = {}
    if "conv_0" in p:
        _conv_trunk(out, p, prefix)
    else:
        _mlp(out, prefix + "fc_net", p["fc_net"])
    for head in ("linear_means", "linear_log_var"):
        _linear(out, prefix + head, p[head])
    return out


def _decoder(p, prefix):
    out = {}
    if "upsample" in p:
        perm = _nhwc_to_nchw_perm()
        out[prefix + "upsample.0.weight"] = np.asarray(p["upsample"]["kernel"])[:, perm].T
        out[prefix + "upsample.0.bias"] = np.asarray(p["upsample"]["bias"])[perm]
        for fl, th in _DEC_DECONV:
            k = np.asarray(p[fl]["kernel"])
            out[prefix + th + ".weight"] = k[::-1, ::-1].transpose(2, 3, 0, 1)
        for fl, th in _DEC_BN:
            _bn(out, prefix + th, p[fl])
    else:
        _mlp(out, prefix + "deconv_net", p["deconv_net"])
    return out


def params_from_jax(model_name, params):
    """flax params tree (numpy leaves) -> the port's ``state_dict``."""
    out = {}
    if "regressor" in model_name:
        _conv_trunk(out, params, "")
        for j in range(3):
            _linear(out, f"out_net.{2 * j}", params[f"out_{j}"])
    elif "encoder" in params:
        out.update(_encoder(params["encoder"], "encoder."))
        out.update(_decoder(params["decoder"], "decoder."))
    else:
        for name in ("visual_encoder", "tactile_encoder", "pose_encoder"):
            if name in params:
                out.update(_encoder(params[name], name + "."))
        for name in ("visual_decoder", "tactile_decoder", "pose_decoder"):
            if name in params:
                out.update(_decoder(params[name], name + "."))
    return {k: torch.tensor(np.ascontiguousarray(v, dtype=np.float32))
            for k, v in out.items()}


def _bn_stats_prefixed(out, p, prefix, pairs):
    for fl, th in pairs:
        if fl in p:
            out[prefix + th] = {k: torch.tensor(np.asarray(p[fl][k], dtype=np.float32))
                                for k in ("mean", "var")}


def bn_stats_from_jax(model_name, bn_stats):
    """JAX ``bn_stats`` tree -> {port BatchNorm module name: {"mean", "var"}}."""
    out = {}
    if "regressor" in model_name:
        _bn_stats_prefixed(out, bn_stats, "", _ENC_BN)
        return out
    for name, p in bn_stats.items():
        pairs = _DEC_BN if name.endswith("decoder") else _ENC_BN
        _bn_stats_prefixed(out, p, name + ".", pairs)
    return out


_REFERENCE_BN_BUFFERS = (".running_mean", ".running_var", ".num_batches_tracked")


def from_reference_state_dict(sd):
    """A reference ``state_dict`` as the port's: the BatchNorm running
    buffers (which the reference never reads, evaluating in train mode)
    dropped, every tensor float32 on the CPU."""
    return {k: torch.as_tensor(v).detach().to("cpu", torch.float32)
            for k, v in sd.items() if not k.endswith(_REFERENCE_BN_BUFFERS)}
