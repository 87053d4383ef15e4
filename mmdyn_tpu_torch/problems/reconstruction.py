"""Losses and metrics of the model families (port of
``mmdyn_tpu/problems/reconstruction.py``): the MVAE subset-ELBO
(``mvae_evaluate``), the VAE ELBO (``vae_evaluate``) and the regressor's MSE
(``regression_evaluate``).

The reference evaluates the MVAE by running the whole model once per
modality subset, 3 passes without pose and 7 with (mmdyn/pytorch/problems/
problems.py:473-529). As in the JAX package, the same loss is computed with:

1. each modality encoder run once (BatchNorm statistics and dropout shared
   across subsets);
2. one fused PoE + reparameterisation call over all K subset posteriors
   (``fused_poe_reparam``, the CUDA kernel on the card), with independent
   (K, B, D) noise;
3. each image decoder run once over only the subsets that appear in the
   loss, with BatchNorm statistics per subset (``models.vae.Decoder``);
4. each image reconstruction term one ``fused_masked_bce_sum`` call over
   its subsets.

A conditional MVAE hands its condition to both image encoders and both image
decoders, never to the pose pair. The VAE and the regressor run no kernel:
their losses are plain in the JAX package too.

Data parallelism: inside ``parallel.sharded`` a rank evaluates its row block
of the global batch; the noise is its rows of a global draw and the ELBOs
divide by the global batch (``parallel.mesh.global_rows``), so the ranks'
losses sum to the one process's.
"""

from __future__ import annotations

import functools

import torch

from mmdyn_tpu_torch.ops.kernels import fused_masked_bce_sum, fused_poe_reparam
from mmdyn_tpu_torch.ops.losses import bce_with_logits, elbo_loss, kl_divergence, mse
from mmdyn_tpu_torch.parallel.mesh import global_draw, global_rows

# Expert order: [prior, visual, tactile] (+ [pose]).
# Subset rows mirror the reference pass order (problems.py:478-529).
SUBSETS_NO_POSE = (
    (1.0, 1.0, 1.0),  # joint (v, t)
    (1.0, 1.0, 0.0),  # visual only
    (1.0, 0.0, 1.0),  # tactile only
)
VIS_LOSS_NO_POSE = (0, 1)
TAC_LOSS_NO_POSE = (0, 2)

SUBSETS_POSE = (
    (1.0, 1.0, 1.0, 0.0),  # joint (v, t)
    (1.0, 1.0, 0.0, 0.0),  # visual only
    (1.0, 0.0, 1.0, 0.0),  # tactile only
    (1.0, 1.0, 1.0, 1.0),  # joint (v, t, p)
    (1.0, 1.0, 0.0, 1.0),  # (v, p)
    (1.0, 0.0, 1.0, 1.0),  # (t, p)
    (1.0, 0.0, 0.0, 1.0),  # pose only
)
VIS_LOSS_POSE = (0, 1, 3, 4)
TAC_LOSS_POSE = (0, 2, 3, 5)
POSE_LOSS_POSE = (3, 4, 5, 6)


@functools.lru_cache(maxsize=None)
def _tables(use_pose: bool, device: torch.device):
    """The subset mask and loss-subset indices on ``device``, made once: a
    host-to-device copy inside the step would wait for the device."""
    if use_pose:
        rows, idx = SUBSETS_POSE, (VIS_LOSS_POSE, TAC_LOSS_POSE, POSE_LOSS_POSE)
    else:
        rows, idx = SUBSETS_NO_POSE, (VIS_LOSS_NO_POSE, TAC_LOSS_NO_POSE, ())
    subsets = torch.tensor(rows, dtype=torch.float32, device=device)
    return (subsets,) + tuple(torch.tensor(i, dtype=torch.long, device=device)
                              for i in idx)


def _img_recon_sum(recons, target, loss_mask):
    """Sum-reduced BCE-with-logits of (K, B, H, W, C) logits against one
    (B, H, W, C) target, through ``fused_masked_bce_sum``.

    The decoder's logits are NHWC views of NCHW memory, and the sum is the
    same under any permutation applied to logits, target and mask alike: so
    the logits go to the kernel in their own NCHW layout, read in place, and
    the K-times smaller target (and mask) are permuted to match.
    """
    def nchw(t):
        return t.movedim(-1, -3).contiguous()

    return fused_masked_bce_sum(recons.movedim(-1, -3), nchw(target),
                                None if loss_mask is None else nchw(loss_mask))


def mvae_evaluate(model, generator, inputs, targets, kl_weight, cfg):
    """Subset-ELBO loss + metrics for the MVAE (problems.py:473-546).

    Args:
        model:     ``models.vae.MVAE``.
        generator: ``torch.Generator`` on the model's device; draws, in order,
                   the visual and tactile dropout masks and the (K, B, D)
                   reparameterisation noise.
        inputs:    'visual', 'tactile' (B, H, W, C), optional 'pose' (B, 7),
                   optional 'shock' (the condition of a conditional model).
        targets:   'visual', 'tactile', optional 'pose', optional 'loss_mask'.
        kl_weight: float or 0-dim tensor.
        cfg:       ``ProblemConfig``.

    Returns:
        (loss, aux): aux holds 'recon_x' (joint reconstructions, NHWC),
        'perf_measure' (mean BCE / MSE of the single-modality subsets,
        problems.py:499-535) and the joint posterior 'means' / 'log_var'.
    """
    use_pose = cfg.use_pose
    visual, tactile = inputs["visual"], inputs["tactile"]
    condition = inputs.get("shock") if cfg.conditional else None
    t_v, t_t = targets["visual"], targets["tactile"]
    loss_mask = targets.get("loss_mask") if cfg.mask_loss else None

    mu_v, lv_v = model.encode_visual(visual, condition, generator)
    mu_t, lv_t = model.encode_tactile(tactile, condition, generator)
    experts_mu = [torch.zeros_like(mu_v), mu_v, mu_t]
    experts_lv = [torch.zeros_like(lv_v), lv_v, lv_t]
    if use_pose:
        mu_p, lv_p = model.encode_pose(inputs["pose"])
        experts_mu.append(mu_p)
        experts_lv.append(lv_p)
    mu_m = torch.stack(experts_mu)      # (M, B, D)
    lv_m = torch.stack(experts_lv)

    subsets, vis_idx, tac_idx, pose_idx = _tables(use_pose, mu_v.device)
    noise_shape = (subsets.shape[0],) + tuple(mu_v.shape)
    if cfg.noise_free:
        noise = torch.zeros(noise_shape, dtype=mu_v.dtype, device=mu_v.device)
    else:
        noise = global_draw(lambda s: torch.randn(s, generator=generator, dtype=mu_v.dtype,
                                                  device=mu_v.device), noise_shape, dim=1)
    z, pd_mu, pd_lv = fused_poe_reparam(mu_m, lv_m, subsets, noise)

    recon_v = model.decode_visual(z.index_select(0, vis_idx), condition)
    recon_t = model.decode_tactile(z.index_select(0, tac_idx), condition)
    recon_error = (_img_recon_sum(recon_v, t_v, loss_mask)
                   + _img_recon_sum(recon_t, t_t, loss_mask))
    if use_pose:
        t_p = targets["pose"]
        recon_p = model.decode_pose(z.index_select(0, pose_idx))
        recon_error = recon_error + cfg.pose_multiplier * mse(
            recon_p, t_p[None].expand_as(recon_p), "sum")

    # KLD summed over every subset's posterior == the sum of per-pass KLDs
    kld = kl_divergence(pd_mu, pd_lv)
    loss = (recon_error + kl_weight * kld) / global_rows(visual.shape[0])

    with torch.no_grad():
        perf = {"visual": bce_with_logits(recon_v[1], t_v, "mean"),
                "tactile": bce_with_logits(recon_t[1], t_t, "mean")}
        if use_pose:
            perf["pose"] = mse(recon_p[3], t_p, "mean")
    # joint reconstructions for logging; with pose the reference logs the
    # 3-modality joint pass (problems.py:507-512, 537)
    recon_x = {"visual": recon_v[2 if use_pose else 0].detach(),
               "tactile": recon_t[2 if use_pose else 0].detach()}
    if use_pose:
        recon_x["pose"] = recon_p[0].detach()
    return loss, {"recon_x": recon_x, "perf_measure": perf,
                  "means": pd_mu[0].detach(), "log_var": pd_lv[0].detach()}


def vae_evaluate(model, generator, inputs, targets, kl_weight, cfg):
    """VAE ELBO loss + metrics (problems.py:683-716 for seq_modeling; the
    reconstruction path, problems.py:460-471, is its targets == inputs case).
    ``generator`` draws the dropout mask, then the reparameterisation noise.
    """
    x = inputs["x"]
    condition = inputs.get("shock") if cfg.conditional else None
    target = targets["x"]
    loss_mask = targets.get("loss_mask") if cfg.mask_loss else None
    recon, mu, lv = model(x, condition, generator)
    loss = elbo_loss(recon, target, mu, lv, kl_weight=kl_weight, loss_mask=loss_mask,
                     batch_size=global_rows(target.shape[0]))
    recon = recon.detach().reshape(target.shape)
    perf = {cfg.input_type: bce_with_logits(recon, target, "mean")}
    return loss, {"recon_x": recon, "perf_measure": perf,
                  "means": mu.detach(), "log_var": lv.detach()}


def regression_evaluate(model, generator, inputs, targets, kl_weight, cfg):
    """MSE-sum pose regression, not divided by the batch (problems.py:318-331).
    ``kl_weight`` is unused; ``generator`` draws the dropout mask."""
    condition = inputs.get("shock") if cfg.conditional else None
    target = targets["pose"]
    out = model(inputs["x"], condition, generator).reshape(target.shape)
    loss = mse(out, target, "sum")
    out = out.detach()
    return loss, {"outputs": out, "perf_measure": {"pose": mse(out, target, "mean")}}
