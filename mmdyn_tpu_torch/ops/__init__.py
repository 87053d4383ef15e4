"""Numerics shared by models and problems, and the fused CUDA kernels."""

from mmdyn_tpu_torch.ops.kernels import fused_masked_bce_sum, fused_poe_reparam
from mmdyn_tpu_torch.ops.losses import (
    bce_with_logits,
    elbo_loss,
    kl_divergence,
    mse,
    mvae_elbo_loss,
)
from mmdyn_tpu_torch.ops.poe import (
    masked_poe,
    prior_expert,
    product_of_experts,
    reparametrize,
)
