"""Encoders, decoders and the multimodal VAE (port of
``mmdyn_tpu/models/vae.py``; reference mmdyn/pytorch/models/vae.py).

* ``Encoder`` (vae.py:179-242): DCGAN conv trunk 3 -> 32 -> 64 -> 128
  (k=4, s=2, p=1) -> 256 (k=4, s=1, p=0), Swish, BatchNorm after all but the
  first conv, no conv biases; FC 6400 -> 512 + Swish + Dropout(0.1); heads
  ``linear_means`` / ``linear_log_var``. 64x64 input -> 5x5x256 bottleneck.
  The MLP variant (the pose encoder) is an ``Mlp`` whose last layer has no
  activation and feeds the heads.
* ``Decoder`` (vae.py:245-301): Linear(latent -> 6400) + Swish, reshape to
  256x5x5, ConvTranspose (k=4) 256->128 (s=1, p=0), 128->64, 64->32, 32->3
  (s=2, p=1) with BatchNorm + Swish between; the output is logits.
* ``MVAE`` (vae.py:101-176): visual and tactile encoder/decoder pairs, an
  optional pose MLP pair (7 <-> [512, 512]), the prior expert and PoE fusion.

Layout: images enter and leave in NHWC, as in the JAX package; the convs run
NCHW inside, so the encoder FC and the decoder ``upsample`` flatten NCHW, as
the reference does (``utils/weights.py`` permutes the JAX weights to match).
Submodules are named as the reference's torch ``state_dict``.

Randomness: dropout masks and reparameterisation noise come from an explicit
``torch.Generator``, consumed in call order.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn

from mmdyn_tpu_torch.config import DROPOUT_RATE
from mmdyn_tpu_torch.models.layers import Mlp, Swish, TrainBatchNorm, dropout
from mmdyn_tpu_torch.ops.poe import prior_expert, product_of_experts, reparametrize

BOTTLENECK = (256, 5, 5)   # (C, H, W) between the conv trunks and the FCs


class Encoder(nn.Module):
    """CNN (NHWC image) or MLP (vector) encoder emitting (means, log_vars)."""

    def __init__(self, latent_size: int = 8, architecture: str = "cnn",
                 input_dim: int = 784, layer_sizes: Sequence[int] = (256, 256),
                 dropout_rate: float = DROPOUT_RATE):
        super().__init__()
        self.architecture = architecture
        self.dropout_rate = dropout_rate
        if architecture == "cnn":
            self.conv_net = nn.Sequential(
                nn.Conv2d(3, 32, 4, 2, 1, bias=False), Swish(),
                nn.Conv2d(32, 64, 4, 2, 1, bias=False), TrainBatchNorm(64), Swish(),
                nn.Conv2d(64, 128, 4, 2, 1, bias=False), TrainBatchNorm(128), Swish(),
                nn.Conv2d(128, 256, 4, 1, 0, bias=False), TrainBatchNorm(256), Swish(),
            )
            self.fc_net = nn.Sequential(nn.Linear(math.prod(BOTTLENECK), 512), Swish())
            hidden = 512
        else:
            self.fc_net = Mlp(input_dim, layer_sizes, "relu")
            hidden = layer_sizes[-1]
        self.linear_means = nn.Linear(hidden, latent_size)
        self.linear_log_var = nn.Linear(hidden, latent_size)

    def forward(self, x, generator=None):
        if self.architecture == "cnn":
            h = self.conv_net(x.permute(0, 3, 1, 2).contiguous())  # NHWC -> NCHW
            h = self.fc_net(h.flatten(1))                           # NCHW flatten
            h = dropout(h, self.dropout_rate, generator)
        else:
            h = self.fc_net(x.reshape(x.shape[0], -1))
        return self.linear_means(h), self.linear_log_var(h)


class Decoder(nn.Module):
    """CNN decoder to (..., B, 64, 64, 3) NHWC logits, or MLP decoder.

    ``z`` is (B, D) or (K, B, D). With a leading subset axis the K batches
    run through every layer at once, but each BatchNorm takes its statistics
    per subset, as the JAX package's ``vmap`` over K does: folding K into the
    batch would mix the subsets' statistics.
    """

    def __init__(self, latent_size: int = 2, architecture: str = "cnn",
                 output_dim: int = 784, layer_sizes: Sequence[int] = (256, 256)):
        super().__init__()
        self.architecture = architecture
        if architecture == "cnn":
            self.upsample = nn.Sequential(
                nn.Linear(latent_size, math.prod(BOTTLENECK)), Swish())
            self.hallucinate = nn.Sequential(
                nn.ConvTranspose2d(256, 128, 4, 1, 0, bias=False), TrainBatchNorm(128), Swish(),
                nn.ConvTranspose2d(128, 64, 4, 2, 1, bias=False), TrainBatchNorm(64), Swish(),
                nn.ConvTranspose2d(64, 32, 4, 2, 1, bias=False), TrainBatchNorm(32), Swish(),
                nn.ConvTranspose2d(32, 3, 4, 2, 1, bias=False),
            )
        else:
            self.deconv_net = Mlp(latent_size, tuple(layer_sizes) + (output_dim,), "relu")

    def forward(self, z):
        if self.architecture != "cnn":
            return self.deconv_net(z)
        lead = z.shape[:-1]
        groups = math.prod(lead[:-1])
        h = self.upsample(z.reshape(-1, z.shape[-1])).reshape(-1, *BOTTLENECK)
        for layer in self.hallucinate:
            h = layer(h, groups) if isinstance(layer, TrainBatchNorm) else layer(h)
        return h.reshape(*lead, *h.shape[1:]).movedim(-3, -1)      # NCHW -> NHWC


class MVAE(nn.Module):
    """Multimodal VAE with product-of-experts fusion (vae.py:101-176)."""

    def __init__(self, latent_size: int = 256, use_pose: bool = False,
                 architecture: str = "cnn", dropout_rate: float = DROPOUT_RATE):
        super().__init__()
        if architecture != "cnn":
            raise ValueError("MVAE is not implemented with MLP")
        self.latent_size = latent_size
        self.use_pose = use_pose
        self.visual_encoder = Encoder(latent_size, dropout_rate=dropout_rate)
        self.visual_decoder = Decoder(latent_size)
        self.tactile_encoder = Encoder(latent_size, dropout_rate=dropout_rate)
        self.tactile_decoder = Decoder(latent_size)
        if use_pose:
            # the pose pathway is an unconditional MLP pair (vae.py:117-123)
            self.pose_encoder = Encoder(latent_size, "mlp", input_dim=7,
                                        layer_sizes=(512, 512))
            self.pose_decoder = Decoder(latent_size, "mlp", output_dim=7,
                                        layer_sizes=(512, 512))

    # --- single-modality primitives used by the subset-ELBO ---

    def encode_visual(self, x, generator=None):
        return self.visual_encoder(x, generator)

    def encode_tactile(self, x, generator=None):
        return self.tactile_encoder(x, generator)

    def encode_pose(self, pose):
        return self.pose_encoder(pose)

    def decode_visual(self, z):
        return self.visual_decoder(z)

    def decode_tactile(self, z):
        return self.tactile_decoder(z)

    def decode_pose(self, z):
        return self.pose_decoder(z)

    # --- reference-parity joint forward (vae.py:126-165) ---

    def forward(self, x, pose=None, generator=None):
        visual, tactile = x
        present = [m for m in (visual, tactile, pose) if m is not None]
        b = present[0].shape[0]
        device = present[0].device
        mu0, lv0 = prior_expert((1, b, self.latent_size), device=device)
        mus, lvs = [mu0], [lv0]
        if visual is not None:
            mu, lv = self.visual_encoder(visual, generator)
            mus.append(mu[None]); lvs.append(lv[None])
        if tactile is not None:
            mu, lv = self.tactile_encoder(tactile, generator)
            mus.append(mu[None]); lvs.append(lv[None])
        if pose is not None and self.use_pose:
            mu, lv = self.pose_encoder(pose)
            mus.append(mu[None]); lvs.append(lv[None])
        mu, log_var = product_of_experts(torch.cat(mus), torch.cat(lvs))
        z = reparametrize(generator, mu, log_var)
        visual_recon = self.visual_decoder(z)
        tactile_recon = self.tactile_decoder(z)
        pose_recon = self.pose_decoder(z) if self.use_pose else None
        return visual_recon, tactile_recon, pose_recon, mu, log_var

    def inference(self, z):
        """Decode prior samples into (visual, tactile) logits (vae.py:167-176)."""
        return self.visual_decoder(z), self.tactile_decoder(z)
