"""Port parity: ``mmdyn_tpu_torch.ops`` against ``mmdyn_tpu.ops``.

The same numpy inputs, made from a seed, go through the JAX function and its
counterpart in the port (CPU path: the kernels' plain versions behind their
``autograd.Function``s).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmdyn_tpu.ops import kernels as jk
from mmdyn_tpu.ops import losses as jl
from mmdyn_tpu.ops import poe as jpoe
from mmdyn_tpu.problems.reconstruction import SUBSETS_NO_POSE, SUBSETS_POSE

from mmdyn_tpu_torch.ops import kernels as tk
from mmdyn_tpu_torch.ops import losses as tl
from mmdyn_tpu_torch.ops import poe as tpoe

SUBSET_TABLES = {"no_pose": SUBSETS_NO_POSE, "pose": SUBSETS_POSE}


def _poe_data(table, seed=0, b=6, d=16):
    rng = np.random.default_rng(seed)
    mask = np.array(SUBSET_TABLES[table], np.float32)
    k, m = mask.shape
    mu = rng.normal(size=(m, b, d)).astype(np.float32)
    lv = rng.normal(size=(m, b, d)).astype(np.float32)
    noise = rng.normal(size=(k, b, d)).astype(np.float32)
    return mu, lv, mask, noise


def _bce_data(seed=0, k=4, b=6, p=96):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(k, b, p)).astype(np.float32)
    target = rng.uniform(size=(b, p)).astype(np.float32)
    mask = (rng.uniform(size=(b, p)) > 0.3).astype(np.float32)
    return logits, target, mask


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


# --- fused PoE + reparameterisation ----------------------------------------

@pytest.mark.parametrize("table", ["no_pose", "pose"])
@pytest.mark.parametrize("fn", ["plain", "wrapper"])
def test_poe_reparam_matches_jax(table, fn):
    mu, lv, mask, noise = _poe_data(table)
    want = jk._poe_reparam_jnp(*map(jnp.asarray, (mu, lv, mask, noise)))
    port = tk.poe_reparam_plain if fn == "plain" else tk.fused_poe_reparam
    got = port(*_t(mu, lv, mask, noise))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5, atol=1e-6)


def _poe_loss(z, pd_mu, pd_lv, kl, sin):
    return (sin(z) * z).sum() + kl(pd_mu, pd_lv)


@pytest.mark.parametrize("table", ["no_pose", "pose"])
def test_poe_reparam_grads_match_jax(table):
    """The analytic backward of the port == jax.grad through the JAX custom
    VJP, on a loss that reads z, pd_mu and pd_lv like the subset-ELBO."""
    mu, lv, mask, noise = _poe_data(table, seed=1)

    def jax_loss(mu_, lv_):
        out = jk.fused_poe_reparam(mu_, lv_, jnp.asarray(mask), jnp.asarray(noise))
        return _poe_loss(*out, jl.kl_divergence, jnp.sin)

    want = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(mu), jnp.asarray(lv))
    tmu, tlv = (torch.tensor(a, requires_grad=True) for a in (mu, lv))
    out = tk.fused_poe_reparam(tmu, tlv, torch.tensor(mask), torch.tensor(noise))
    _poe_loss(*out, tl.kl_divergence, torch.sin).backward()
    for g, w in zip((tmu.grad, tlv.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-6)


def test_poe_reparam_backward_gradcheck():
    """The hand-written backward against finite differences, in float64."""
    mu, lv, mask, noise = (torch.tensor(a, dtype=torch.float64)
                           for a in _poe_data("pose", seed=2, b=2, d=3))
    mu.requires_grad_(True)
    lv.requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda a, b: tk.fused_poe_reparam(a, b, mask, noise), (mu, lv))


@pytest.mark.parametrize("bad", ["experts", "subsets", "dtype", "strided"])
def test_poe_reparam_cuda_rejects_bad_input(bad):
    """The kernel wrapper's checks run before any build or launch."""
    mu, lv, mask, noise = _t(*_poe_data("pose"))
    if bad == "experts":
        mu, lv = torch.cat([mu, mu[:1]]), torch.cat([lv, lv[:1]])
        mask = torch.cat([mask, mask[:, :1]], 1)
        match = "at most 4 experts"
    elif bad == "subsets":
        mask, noise = torch.cat([mask, mask[:1]]), torch.cat([noise, noise[:1]])
        match = "at most 7 subsets"
    elif bad == "dtype":
        mu = mu.double()
        match = "float32 expected"
    else:
        mu = mu.transpose(1, 2).contiguous().transpose(1, 2)
        match = "contiguous"
    with pytest.raises(ValueError, match=match):
        tk._poe_reparam_cuda(mu, lv, mask, noise)


# --- fused masked BCE + sum --------------------------------------------------

@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("fn", ["plain", "wrapper"])
def test_bce_sum_matches_jax(with_mask, fn):
    logits, target, mask = _bce_data()
    m = mask if with_mask else None
    want = jk._bce_jnp(jnp.asarray(logits), jnp.asarray(target),
                       None if m is None else jnp.asarray(m))
    port = tk.bce_sum_plain if fn == "plain" else tk.fused_masked_bce_sum
    got = port(torch.tensor(logits), torch.tensor(target),
               None if m is None else torch.tensor(m))
    # rtol 1e-5: the two frameworks sum in different orders
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("with_mask", [False, True])
def test_bce_sum_grad_matches_jax(with_mask):
    logits, target, mask = _bce_data(seed=3)
    m = mask if with_mask else None
    g = 0.37
    want, _, _ = jk._bce_bwd(
        (jnp.asarray(logits), jnp.asarray(target),
         None if m is None else jnp.asarray(m)), jnp.float32(g))
    x = torch.tensor(logits, requires_grad=True)
    out = tk.fused_masked_bce_sum(x, torch.tensor(target),
                                  None if m is None else torch.tensor(m))
    (g * out).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_bce_sum_trailing_dims_and_broadcast_form():
    """(K, B, H, W, C) logits against a (B, H, W, C) target: the K-sum form
    equals the broadcast reference loss."""
    rng = np.random.default_rng(5)
    logits = torch.tensor(rng.normal(size=(3, 4, 8, 8, 3)).astype(np.float32))
    target = torch.tensor(rng.uniform(size=(4, 8, 8, 3)).astype(np.float32))
    got = tk.fused_masked_bce_sum(logits, target)
    want = tl.bce_with_logits(logits, target.expand_as(logits), "sum")
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_cpu_path_never_touches_launch_counters():
    before = (tk.fused_poe_reparam.launches, tk.fused_masked_bce_sum.launches)
    mu, lv, mask, noise = _t(*_poe_data("pose"))
    mu.requires_grad_(True)
    z, _, _ = tk.fused_poe_reparam(mu, lv, mask, noise)
    logits, target, _ = _t(*_bce_data())
    (z.sum() + tk.fused_masked_bce_sum(logits, target)).backward()
    assert (tk.fused_poe_reparam.launches,
            tk.fused_masked_bce_sum.launches) == before == (0, 0)


def test_other_devices_raise():
    x = torch.empty((4, 2, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tk.fused_masked_bce_sum(x, torch.empty((2, 8), device="meta"))


# --- poe.py ------------------------------------------------------------------

def test_product_of_experts_and_prior_match_jax():
    mu, lv, _, _ = _poe_data("pose", seed=4)
    want = jpoe.product_of_experts(jnp.asarray(mu), jnp.asarray(lv))
    got = tpoe.product_of_experts(*_t(mu, lv))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5, atol=1e-6)
    for g, w in zip(tpoe.prior_expert((2, 3)), jpoe.prior_expert((2, 3))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("row", range(len(SUBSETS_POSE)))
def test_masked_poe_matches_jax(row):
    mu, lv, mask, _ = _poe_data("pose", seed=6)
    want = jpoe.masked_poe(jnp.asarray(mu), jnp.asarray(lv), jnp.asarray(mask[row]))
    got = tpoe.masked_poe(*_t(mu, lv), torch.tensor(mask[row]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5, atol=1e-6)


def test_reparametrize_draws_from_the_generator():
    mu, lv, _, _ = _t(*_poe_data("pose", seed=7))
    z = tpoe.reparametrize(torch.Generator().manual_seed(3), mu, lv)
    eps = torch.randn(mu.shape, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(z, eps * torch.exp(0.5 * lv) + mu)


# --- losses.py ---------------------------------------------------------------

@pytest.mark.parametrize("reduction", ["sum", "mean", "none"])
@pytest.mark.parametrize("name", ["bce_with_logits", "mse"])
def test_elementwise_losses_match_jax(name, reduction):
    logits, target, _ = _bce_data(seed=8)
    want = getattr(jl, name)(jnp.asarray(logits), jnp.asarray(target[None]), reduction)
    got = getattr(tl, name)(*_t(logits, target[None]), reduction)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("with_mask", [False, True])
def test_elbo_losses_match_jax(with_mask):
    rng = np.random.default_rng(9)
    b, d = 4, 16
    x = rng.uniform(size=(b, 8, 8, 3)).astype(np.float32)
    recon = rng.normal(size=(b, 8 * 8 * 3)).astype(np.float32)
    mu, lv = (rng.normal(size=(b, d)).astype(np.float32) for _ in range(2))
    mask = (rng.uniform(size=x.shape) > 0.5).astype(np.float32) if with_mask else None
    pose_r, pose_x = (rng.normal(size=(b, 7)).astype(np.float32) for _ in range(2))

    def j(a):
        return None if a is None else jnp.asarray(a)

    def t(a):
        return None if a is None else torch.tensor(a)

    want = jl.elbo_loss(j(recon), j(x), j(mu), j(lv), 0.3, j(mask))
    got = tl.elbo_loss(t(recon), t(x), t(mu), t(lv), 0.3, t(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(tl.kl_divergence(t(mu), t(lv))),
                               float(jl.kl_divergence(j(mu), j(lv))), rtol=1e-6)
    if not with_mask:   # the pose MSE term takes no image mask
        img = recon.reshape(x.shape)
        want = jl.mvae_elbo_loss([j(img), j(pose_r)], [j(x), j(pose_x)],
                                 j(mu), j(lv), 0.3, 50.0)
        got = tl.mvae_elbo_loss([t(img), t(pose_r)], [t(x), t(pose_x)],
                                t(mu), t(lv), 0.3, 50.0)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
