"""The reference semantics of the MVAE and the pose regressor as plain
PyTorch modules: the golden side of ``tools/elbo_parity.py``.

The port's own copy of the golden models of ``tests/torch_reference.py``
(architecture per the reference's vae.py and models.py; reference
problems.py:421-529 for the loss), with three changes:

* Reparameterisation noise and dropout masks come from an explicit
  ``torch.Generator`` passed in, never from torch's global generator.
* The prior expert is made on the inputs' device.
* The modules are named as the reference's ``state_dict`` names them, which
  the port's models share (``utils/weights.py``): the port's weights load
  with ``load_state_dict``, whose strict default raises on a key that does
  not map, either way.
  BatchNorm keeps no running statistics, as the reference's training never
  reads them.

The MVAE is evaluated as the reference evaluates it: the whole model run
once per modality subset, 7 sequential passes (``mvae_eval``), each with
its own BatchNorm statistics, dropout masks and noise. Everything is
float32, whatever policy the model under test runs.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from mmdyn_tpu_torch.utils.device import resolve_device

DROPOUT_RATE = 0.1          # the reference's Dropout(0.1) (vae.py:207)
POSE_MULTIPLIER = 1000.0    # the reference CLI's default


class GoldSwish(nn.Module):
    def forward(self, x):
        return x * torch.sigmoid(x)


def gold_dropout(h, rate, generator):
    """Inverted dropout (``nn.Dropout``'s semantics), the mask drawn from
    ``generator``."""
    if rate == 0.0:
        return h
    keep = torch.rand(h.shape, generator=generator, device=h.device) >= rate
    return h * keep / (1.0 - rate)


def _conv_trunk():
    return nn.Sequential(
        nn.Conv2d(3, 32, 4, 2, 1, bias=False), GoldSwish(),
        nn.Conv2d(32, 64, 4, 2, 1, bias=False), _bn(64), GoldSwish(),
        nn.Conv2d(64, 128, 4, 2, 1, bias=False), _bn(128), GoldSwish(),
        nn.Conv2d(128, 256, 4, 1, 0, bias=False), _bn(256), GoldSwish(),
    )


def _bn(n):
    # train-mode batch statistics only, as the reference trains and evaluates
    return nn.BatchNorm2d(n, track_running_stats=False)


class GoldEncoder(nn.Module):
    def __init__(self, latent_size, dropout_rate=0.0, condition_dim=0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.conv_net = _conv_trunk()
        self.fc_net = nn.Sequential(nn.Linear(256 * 5 * 5, 512))
        # conditional (CVAE) pathway: the shock vector concatenates between
        # the FC trunk and the heads (vae.py:195-196, :231-237)
        self.linear_means = nn.Linear(512 + condition_dim, latent_size)
        self.linear_log_var = nn.Linear(512 + condition_dim, latent_size)

    def forward(self, x, c=None, generator=None):
        h = self.conv_net(x)
        h = h.reshape(h.size(0), -1)
        h = self.fc_net(h)
        h = h * torch.sigmoid(h)
        h = gold_dropout(h, self.dropout_rate, generator)
        if c is not None:
            h = torch.cat((h, c.float()), dim=-1)
        return self.linear_means(h), self.linear_log_var(h)


class GoldDecoder(nn.Module):
    def __init__(self, latent_size, condition_dim=0):
        super().__init__()
        # conditional: condition concatenates to z (vae.py:259, :285-291)
        self.upsample = nn.Sequential(nn.Linear(latent_size + condition_dim, 256 * 5 * 5))
        self.hallucinate = nn.Sequential(
            nn.ConvTranspose2d(256, 128, 4, 1, 0, bias=False), _bn(128), GoldSwish(),
            nn.ConvTranspose2d(128, 64, 4, 2, 1, bias=False), _bn(64), GoldSwish(),
            nn.ConvTranspose2d(64, 32, 4, 2, 1, bias=False), _bn(32), GoldSwish(),
            nn.ConvTranspose2d(32, 3, 4, 2, 1, bias=False),
        )

    def forward(self, z, c=None):
        if c is not None:
            z = torch.cat((z, c.float()), dim=-1)
        h = self.upsample(z)
        h = h * torch.sigmoid(h)
        return self.hallucinate(h.reshape(-1, 256, 5, 5))


class GoldMlp(nn.Sequential):
    """Linear->ReLU stack with identity output (vae.py:14-19 semantics)."""

    def __init__(self, sizes):
        layers = []
        for j in range(len(sizes) - 1):
            layers.append(nn.Linear(sizes[j], sizes[j + 1]))
            if j < len(sizes) - 2:
                layers.append(nn.ReLU())
        super().__init__(*layers)


class GoldPoseEncoder(nn.Module):
    def __init__(self, latent_size):
        super().__init__()
        self.fc_net = GoldMlp([7, 512, 512])
        self.linear_means = nn.Linear(512, latent_size)
        self.linear_log_var = nn.Linear(512, latent_size)

    def forward(self, pose):
        h = self.fc_net(pose)
        return self.linear_means(h), self.linear_log_var(h)


class GoldPoseDecoder(nn.Module):
    def __init__(self, latent_size):
        super().__init__()
        self.deconv_net = GoldMlp([latent_size, 512, 512, 7])

    def forward(self, z):
        return self.deconv_net(z)


def gold_poe(mu, logvar, eps=1e-8):
    var = torch.exp(logvar) + eps
    T = 1.0 / (var + eps)
    pd_mu = torch.sum(mu * T, dim=0) / torch.sum(T, dim=0)
    pd_var = 1.0 / torch.sum(T, dim=0)
    return pd_mu, torch.log(pd_var + eps)


class GoldMVAE(nn.Module):
    """Reference-semantics MVAE over visual, tactile and pose; the pose
    pathway is unconditional (vae.py:118-123)."""

    def __init__(self, latent_size, dropout_rate=0.0, condition_dim=0):
        super().__init__()
        self.latent_size = latent_size
        self.visual_encoder = GoldEncoder(latent_size, dropout_rate, condition_dim)
        self.visual_decoder = GoldDecoder(latent_size, condition_dim)
        self.tactile_encoder = GoldEncoder(latent_size, dropout_rate, condition_dim)
        self.tactile_decoder = GoldDecoder(latent_size, condition_dim)
        self.pose_encoder = GoldPoseEncoder(latent_size)
        self.pose_decoder = GoldPoseDecoder(latent_size)

    def posterior(self, v, t, p, cond=None, generator=None, noise_free=False):
        """One subset's pass up to the latent: the prior expert and the
        experts of the modalities given (None: absent), their product, and
        z = mu + noise * std with the noise from ``generator`` (vae.py:52-61),
        or z = mu when ``noise_free``. Returns (z, mu, logvar)."""
        present = [x for x in (v, t, p) if x is not None]
        b, device = present[0].size(0), present[0].device
        mus = [torch.zeros(1, b, self.latent_size, device=device)]
        lvs = [torch.zeros(1, b, self.latent_size, device=device)]
        if v is not None:
            mu, lvr = self.visual_encoder(v, cond, generator)
            mus.append(mu[None]); lvs.append(lvr[None])
        if t is not None:
            mu, lvr = self.tactile_encoder(t, cond, generator)
            mus.append(mu[None]); lvs.append(lvr[None])
        if p is not None:
            mu, lvr = self.pose_encoder(p)
            mus.append(mu[None]); lvs.append(lvr[None])
        mu, lv = gold_poe(torch.cat(mus), torch.cat(lvs))
        if noise_free:
            return mu, mu, lv
        std = torch.exp(0.5 * lv)
        noise = torch.randn(std.shape, generator=generator, device=device)
        return mu + noise * std, mu, lv


def gold_mvae_elbo(recons, xs, mu, logvar, kl_weight, pose_multiplier):
    """problems.py:421-458 semantics."""
    b = xs[0].size(0)
    kld = -0.5 * torch.sum(1 + logvar - mu.pow(2) - logvar.exp())
    err = 0.0
    for r, x in zip(recons, xs):
        if r.dim() > 2:
            err = err + F.binary_cross_entropy_with_logits(
                r.reshape(x.shape), x, reduction="sum")
        else:
            err = err + pose_multiplier * F.mse_loss(r, x, reduction="sum")
    return (err + kl_weight * kld) / b


def mvae_eval(m, bv, bt, bp, gv, gt, gp, klw, cond=None, generator=None,
              noise_free=False):
    """The reference's sequential 7-subset evaluation (problems.py:473-529):
    per subset the whole model runs on the modalities given and is scored on
    the reconstructions of those modalities. ``generator`` draws each pass's
    dropout masks and, unless ``noise_free``, its noise. Returns the summed
    loss."""
    def score(v, t, p):
        z, mu, lv = m.posterior(v, t, p, cond, generator, noise_free)
        recons, xs = [], []
        if v is not None:
            recons.append(m.visual_decoder(z, cond)); xs.append(gv)
        if t is not None:
            recons.append(m.tactile_decoder(z, cond)); xs.append(gt)
        if p is not None:
            recons.append(m.pose_decoder(z)); xs.append(gp)
        return gold_mvae_elbo(recons, xs, mu, lv, klw, POSE_MULTIPLIER)

    loss = 0
    for v, t, p in ((bv, bt, None), (bv, None, None), (None, bt, None), (bv, bt, bp),
                    (bv, None, bp), (None, bt, bp), (None, None, bp)):
        loss = loss + score(v, t, p)
    return loss


class GoldRegressor(nn.Module):
    """Reference-semantics CNN pose regressor (models.py:28-77): the encoder
    conv trunk, FC 6400 -> 512 + Swish (+ Dropout), MLP 512 -> 256 -> 256 ->
    out_dim with ReLU between."""

    def __init__(self, out_dim=7, dropout_rate=0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.conv_net = _conv_trunk()
        self.fc_net = nn.Sequential(nn.Linear(256 * 5 * 5, 512))
        self.out_net = nn.Sequential(
            nn.Linear(512, 256), nn.ReLU(),
            nn.Linear(256, 256), nn.ReLU(),
            nn.Linear(256, out_dim),
        )

    def forward(self, x, generator=None):
        h = self.conv_net(x)
        h = h.reshape(h.size(0), -1)
        h = self.fc_net(h)
        h = h * torch.sigmoid(h)
        return self.out_net(gold_dropout(h, self.dropout_rate, generator))


def make_gold(regression, latent_size, condition_dim=0, dropout_rate=0.0, seed=0,
              device=None):
    """A golden model with torch's default init drawn under ``seed``, on
    ``device`` (``None``: the card, see ``utils/device.py::resolve_device``);
    torch's global generator is left as it was."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        if regression:
            model = GoldRegressor(out_dim=7, dropout_rate=dropout_rate)
        else:
            model = GoldMVAE(latent_size, dropout_rate, condition_dim)
    return model.to(device)

