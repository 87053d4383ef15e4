"""Encoders, decoders, the VAE and the multimodal VAE (port of
``mmdyn_tpu/models/vae.py``; reference mmdyn/pytorch/models/vae.py).

* ``Encoder`` (vae.py:179-242): DCGAN conv trunk 3 -> 32 -> 64 -> 128
  (k=4, s=2, p=1) -> 256 (k=4, s=1, p=0), Swish, BatchNorm after all but the
  first conv, no conv biases; FC 6400 -> 512 + Swish + Dropout(0.1); the
  condition, when the model is conditional; heads ``linear_means`` /
  ``linear_log_var``. 64x64 input -> 5x5x256 bottleneck. The MLP variant is
  an ``Mlp`` whose last layer has no activation and feeds the heads.
* ``Decoder`` (vae.py:245-301): the condition, when conditional, joins z;
  Linear(latent -> 6400) + Swish, reshape to 256x5x5, ConvTranspose (k=4)
  256->128 (s=1, p=0), 128->64, 64->32, 32->3 (s=2, p=1) with BatchNorm +
  Swish between; the output is logits. The MLP variant is an ``Mlp``.
* ``VAE`` (vae.py:70-98): encode -> reparametrize -> decode; the MLP VAE
  folds an image's channel planes into rows, as the reference's
  ``view(-1, input_dim)`` does.
* ``MVAE`` (vae.py:101-176): visual and tactile encoder/decoder pairs, an
  optional pose MLP pair (7 <-> [512, 512], never conditional), the prior
  expert and PoE fusion.

A condition is a (B, S) float vector, or with ``categorical_conditions`` a
class id per row that becomes a one-hot of width ``condition_dim``. It is
concatenated after the features, so a conditional model's heads and
``upsample`` (or first decoder MLP layer) take ``condition_dim`` more inputs.
torch layers are sized when built, so a conditional model needs
``condition_dim`` (flax infers it at init).

Layout: images enter and leave in NHWC, as in the JAX package; the convs run
NCHW inside, so the encoder FC and the decoder ``upsample`` flatten NCHW, as
the reference does (``utils/weights.py`` permutes the JAX weights to match).
Submodules are named as the reference's torch ``state_dict``.

Randomness: dropout masks and reparameterisation noise come from an explicit
``torch.Generator``, consumed in call order.

Serving: ``bn_mode`` is the mode of every BatchNorm (``batch``, ``collect``
or ``frozen``, ``models/layers.py``), as the JAX modules' ``bn_mode`` field.

The cnn trunks run through ``models/layers.py::run_sequential``: each
BatchNorm + Swish pair is one fused call, each lone Swish ``F.silu``.

Precision: ``compute_dtype`` is the activation policy of every conv and
Linear (``models/layers.py``). The encoder heads return float32 under every
policy, so PoE, reparameterisation and KL run in float32 (JAX vae.py:120-122).
The CNN decoder's last transposed conv returns bf16 logits under
``bfloat16_full`` and float32 otherwise (vae.py:163-170); the MLP decoder
always returns float32 (:175).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn

from mmdyn_tpu_torch.config import DROPOUT_RATE
from mmdyn_tpu_torch.models.layers import (Conv2d, ConvTranspose2d, Linear, Mlp, Swish,
                                           TrainBatchNorm, dropout, run_sequential)
from mmdyn_tpu_torch.ops.poe import prior_expert, product_of_experts, reparametrize

BOTTLENECK = (256, 5, 5)   # (C, H, W) between the conv trunks and the FCs


def idx2onehot(idx, n):
    """Class ids -> (N, n) one-hot (vae.py:337-344). The ids are compared
    with 0..n-1 in their own dtype, as ``jax.nn.one_hot`` does: float ids
    (every batch entry reaches the step as float32) work, and an id outside
    [0, n) gives a row of zeros."""
    idx = idx.reshape(-1, 1)
    return (idx == torch.arange(n, device=idx.device, dtype=idx.dtype)).float()


def _concat_condition(x, c, categorical, condition_dim):
    """Concatenate a (possibly categorical) condition after the features of
    ``x`` (vae.py:231-237). A (B, S) condition joins every leading slice of
    a (K, B, F) ``x``, as the JAX package's vmap over K closes over it."""
    if c is None:
        return x
    if categorical:
        c = idx2onehot(c, condition_dim)
    elif c.dim() == 1:
        c = c[:, None]
    c = c.to(x.dtype).expand(x.shape[:-1] + c.shape[-1:])
    return torch.cat([x, c], dim=-1)


def condition_width(conditional, condition_dim):
    if not conditional:
        return 0
    if condition_dim is None:
        raise ValueError("a conditional model needs condition_dim")
    return condition_dim


def conv_trunk(compute_dtype="float32", bn_mode="batch"):
    """The DCGAN trunk of the encoders and the regressor, NCHW in and out."""
    conv = lambda *a: Conv2d(*a, bias=False, compute_dtype=compute_dtype)  # noqa: E731
    bn = lambda c: TrainBatchNorm(c, mode=bn_mode)  # noqa: E731
    return nn.Sequential(
        conv(3, 32, 4, 2, 1), Swish(),
        conv(32, 64, 4, 2, 1), bn(64), Swish(),
        conv(64, 128, 4, 2, 1), bn(128), Swish(),
        conv(128, 256, 4, 1, 0), bn(256), Swish(),
    )


class Encoder(nn.Module):
    """CNN (NHWC image) or MLP (vector) encoder emitting (means, log_vars)."""

    def __init__(self, latent_size: int = 8, architecture: str = "cnn",
                 input_dim: int = 784, layer_sizes: Sequence[int] = (256, 256),
                 conditional: bool = False, categorical_conditions: bool = False,
                 condition_dim: Optional[int] = None,
                 dropout_rate: float = DROPOUT_RATE, compute_dtype: str = "float32",
                 bn_mode: str = "batch"):
        super().__init__()
        self.architecture = architecture
        self.dropout_rate = dropout_rate
        self.conditional = conditional
        self.categorical_conditions = categorical_conditions
        self.condition_dim = condition_dim
        dt = compute_dtype
        if architecture == "cnn":
            self.conv_net = conv_trunk(dt, bn_mode)
            self.fc_net = nn.Sequential(
                Linear(math.prod(BOTTLENECK), 512, compute_dtype=dt), Swish())
            hidden = 512
        else:
            self.fc_net = Mlp(input_dim, layer_sizes, "relu", compute_dtype=dt)
            hidden = layer_sizes[-1]
        hidden += condition_width(conditional, condition_dim)
        self.linear_means = Linear(hidden, latent_size, compute_dtype=dt)
        self.linear_log_var = Linear(hidden, latent_size, compute_dtype=dt)

    def forward(self, x, c=None, generator=None):
        if self.architecture == "cnn":
            h = run_sequential(self.conv_net, x.permute(0, 3, 1, 2).contiguous())  # NCHW
            h = run_sequential(self.fc_net, h.flatten(1))                     # NCHW flatten
            h = dropout(h, self.dropout_rate, generator)
        else:
            h = self.fc_net(x.reshape(x.shape[0], -1))
        if self.conditional:   # after dropout, before the heads (vae.py:114-115)
            h = _concat_condition(h, c, self.categorical_conditions, self.condition_dim)
        return self.linear_means(h).float(), self.linear_log_var(h).float()


class Decoder(nn.Module):
    """CNN decoder to (..., B, 64, 64, 3) NHWC logits, or MLP decoder.

    ``z`` is (B, D) or (K, B, D). With a leading subset axis the K batches
    run through every layer at once, but each BatchNorm takes its statistics
    per subset, as the JAX package's ``vmap`` over K does: folding K into the
    batch would mix the subsets' statistics. A (B, S) condition joins each of
    the K batches.
    """

    def __init__(self, latent_size: int = 2, architecture: str = "cnn",
                 output_dim: int = 784, layer_sizes: Sequence[int] = (256, 256),
                 conditional: bool = False, categorical_conditions: bool = False,
                 condition_dim: Optional[int] = None, compute_dtype: str = "float32",
                 bn_mode: str = "batch"):
        super().__init__()
        self.architecture = architecture
        self.conditional = conditional
        self.categorical_conditions = categorical_conditions
        self.condition_dim = condition_dim
        dt = compute_dtype
        fan_in = latent_size + condition_width(conditional, condition_dim)
        if architecture == "cnn":
            deconv = lambda *a: ConvTranspose2d(*a, bias=False, compute_dtype=dt)  # noqa: E731
            bn = lambda c: TrainBatchNorm(c, mode=bn_mode)  # noqa: E731
            self.upsample = nn.Sequential(
                Linear(fan_in, math.prod(BOTTLENECK), compute_dtype=dt), Swish())
            self.hallucinate = nn.Sequential(
                deconv(256, 128, 4, 1, 0), bn(128), Swish(),
                deconv(128, 64, 4, 2, 1), bn(64), Swish(),
                deconv(64, 32, 4, 2, 1), bn(32), Swish(),
                deconv(32, 3, 4, 2, 1),
            )
        else:
            self.deconv_net = Mlp(fan_in, tuple(layer_sizes) + (output_dim,), "relu",
                                  compute_dtype=dt)

    def forward(self, z, c=None):
        if self.conditional:   # before upsample / the MLP (vae.py:142-143)
            z = _concat_condition(z, c, self.categorical_conditions, self.condition_dim)
        if self.architecture != "cnn":
            return self.deconv_net(z).float()
        lead = z.shape[:-1]
        groups = math.prod(lead[:-1])
        h = run_sequential(self.upsample, z.reshape(-1, z.shape[-1])).reshape(-1, *BOTTLENECK)
        h = run_sequential(self.hallucinate, h, groups)
        return h.reshape(*lead, *h.shape[1:]).movedim(-3, -1)      # NCHW -> NHWC


class VAE(nn.Module):
    """Vanilla (optionally conditional) VAE (vae.py:70-98)."""

    def __init__(self, latent_size: int = 256, architecture: str = "cnn",
                 input_dim: int = 784,
                 encoder_layer_sizes: Sequence[int] = (256, 256),
                 decoder_layer_sizes: Sequence[int] = (256, 256),
                 conditional: bool = False, categorical_conditions: bool = False,
                 condition_dim: Optional[int] = None,
                 dropout_rate: float = DROPOUT_RATE, compute_dtype: str = "float32",
                 bn_mode: str = "batch"):
        super().__init__()
        self.latent_size = latent_size
        self.architecture = architecture
        self.input_dim = input_dim
        cond = dict(conditional=conditional,
                    categorical_conditions=categorical_conditions,
                    condition_dim=condition_dim, compute_dtype=compute_dtype,
                    bn_mode=bn_mode)
        self.encoder = Encoder(latent_size, architecture, input_dim,
                               encoder_layer_sizes, dropout_rate=dropout_rate, **cond)
        self.decoder = Decoder(latent_size, architecture, input_dim,
                               decoder_layer_sizes, **cond)

    def forward(self, x, c=None, generator=None):
        """(recon, means, log_var); the MLP VAE's recon is unfolded back to
        the input's NHWC shape."""
        fold = x.dim() > 2 and self.architecture == "mlp"
        if fold:
            # vae.py:82-83 view(-1, input_dim) folds the NCHW channel planes
            # into rows: the NHWC input goes channel-major first, so a
            # (B, 64, 64, 3) image is 3B rows of 4096
            b, h, w, ch = x.shape
            x = x.permute(0, 3, 1, 2).reshape(-1, self.input_dim)
        means, log_var = self.encoder(x, c, generator)
        z = reparametrize(generator, means, log_var)
        recon = self.decoder(z, c)
        if fold:
            recon = recon.reshape(b, ch, h, w).permute(0, 2, 3, 1)
        return recon, means, log_var

    def inference(self, z, c=None):
        """Decode prior samples z ~ N(0, I) (vae.py:90-98)."""
        return self.decoder(z, c)


class MVAE(nn.Module):
    """Multimodal VAE with product-of-experts fusion (vae.py:101-176)."""

    def __init__(self, latent_size: int = 256, use_pose: bool = False,
                 conditional: bool = False, categorical_conditions: bool = False,
                 condition_dim: Optional[int] = None, architecture: str = "cnn",
                 dropout_rate: float = DROPOUT_RATE, compute_dtype: str = "float32",
                 bn_mode: str = "batch"):
        super().__init__()
        if architecture != "cnn":
            raise ValueError("MVAE is not implemented with MLP")
        self.latent_size = latent_size
        self.use_pose = use_pose
        img = dict(conditional=conditional,
                   categorical_conditions=categorical_conditions,
                   condition_dim=condition_dim, compute_dtype=compute_dtype,
                   bn_mode=bn_mode)
        self.visual_encoder = Encoder(latent_size, dropout_rate=dropout_rate, **img)
        self.visual_decoder = Decoder(latent_size, **img)
        self.tactile_encoder = Encoder(latent_size, dropout_rate=dropout_rate, **img)
        self.tactile_decoder = Decoder(latent_size, **img)
        if use_pose:
            # the pose pathway is an unconditional MLP pair (vae.py:117-123)
            self.pose_encoder = Encoder(latent_size, "mlp", input_dim=7,
                                        layer_sizes=(512, 512),
                                        compute_dtype=compute_dtype)
            self.pose_decoder = Decoder(latent_size, "mlp", output_dim=7,
                                        layer_sizes=(512, 512),
                                        compute_dtype=compute_dtype)

    # --- single-modality primitives used by the subset-ELBO ---

    def encode_visual(self, x, c=None, generator=None):
        return self.visual_encoder(x, c, generator)

    def encode_tactile(self, x, c=None, generator=None):
        return self.tactile_encoder(x, c, generator)

    def encode_pose(self, pose):
        return self.pose_encoder(pose)

    def decode_visual(self, z, c=None):
        return self.visual_decoder(z, c)

    def decode_tactile(self, z, c=None):
        return self.tactile_decoder(z, c)

    def decode_pose(self, z):
        return self.pose_decoder(z)

    # --- reference-parity joint forward (vae.py:126-165) ---

    def forward(self, x, pose=None, condition=None, generator=None):
        visual, tactile = x
        present = [m for m in (visual, tactile, pose) if m is not None]
        b = present[0].shape[0]
        device = present[0].device
        mu0, lv0 = prior_expert((1, b, self.latent_size), device=device)
        mus, lvs = [mu0], [lv0]
        if visual is not None:
            mu, lv = self.visual_encoder(visual, condition, generator)
            mus.append(mu[None]); lvs.append(lv[None])
        if tactile is not None:
            mu, lv = self.tactile_encoder(tactile, condition, generator)
            mus.append(mu[None]); lvs.append(lv[None])
        if pose is not None and self.use_pose:
            mu, lv = self.pose_encoder(pose)
            mus.append(mu[None]); lvs.append(lv[None])
        mu, log_var = product_of_experts(torch.cat(mus), torch.cat(lvs))
        z = reparametrize(generator, mu, log_var)
        visual_recon = self.visual_decoder(z, condition)
        tactile_recon = self.tactile_decoder(z, condition)
        pose_recon = self.pose_decoder(z) if self.use_pose else None
        return visual_recon, tactile_recon, pose_recon, mu, log_var

    def inference(self, z, c=None):
        """Decode prior samples into (visual, tactile) logits (vae.py:167-176)."""
        return self.visual_decoder(z, c), self.tactile_decoder(z, c)
