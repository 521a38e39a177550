"""The denoise-only losses of the port against the JAX package's.

`full_cov_nll_pme` (the 3-channel ssdn NLL and posterior mean) with A
diagonal and upper triangular, the noise known and estimated: the loss map,
the PME and both s.d. maps within 1e-5 of the largest entry (float32, a
3x3 inverse and determinant per pixel in LAPACK against XLA), and the
gradient of the mean loss with respect to mu, A and the noise s.d. against
`jax.grad` within 1e-4 relative L2.  `masked_mse` and `mse_per_item`:
values and gradients within 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spr_pick_tpu import losses as jlosses
from spr_pick_tpu_torch import losses

B, H, W, C = 2, 5, 6, 3
RTOL = 1e-5
GRAD_L2 = 1e-4


def inputs(seed=0):
    rng = np.random.RandomState(seed)
    noisy = rng.rand(B, H, W, C).astype(np.float32)
    mu = (noisy + 0.2 * rng.randn(B, H, W, C)).astype(np.float32)
    a = (0.4 * rng.randn(B, H, W, C * (C + 1) // 2)).astype(np.float32)
    # The triangle's diagonal in [0.5, 1): sigma_x = A^T A stays well
    # conditioned, so its float32 inverse is not an amplifier of rounding.
    a[..., [0, 3, 5]] = 0.5 + 0.5 * rng.rand(B, H, W, C)
    std = (0.1 + 0.3 * rng.rand(B, H, W, C)).astype(np.float32)
    return noisy, mu, a, std


def sigma_jax(a, diagonal):
    if diagonal:
        return jax.vmap(jnp.diag)(a[..., :C].reshape(-1, C) ** 2).reshape(
            a.shape[:-1] + (C, C))
    rows, cols = np.triu_indices(C)
    tri = jnp.zeros(a.shape[:-1] + (C, C)).at[..., rows, cols].set(a)
    return jnp.einsum("...ji,...jk->...ik", tri, tri)


def sigma_torch(a, diagonal):
    if diagonal:
        return torch.diag_embed(a[..., :C] ** 2)
    rows, cols = np.triu_indices(C)
    tri = a.new_zeros(a.shape[:-1] + (C, C))
    tri[..., rows, cols] = a
    return torch.einsum("...ji,...jk->...ik", tri, tri)


def assert_close(got, want, rtol, name=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    scale = float(np.abs(want).max())
    assert scale > 0, name
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{name}: {err:.3e} > {rtol} * {scale:.3e}"


def rel_l2(got, want):
    return float(np.linalg.norm(np.asarray(got) - np.asarray(want))
                 / np.linalg.norm(np.asarray(want)))


CASES = [(d, k) for d in (True, False) for k in (False, True)]
IDS = [f"{'diag' if d else 'full'}-{'known' if k else 'est'}"
       for d, k in CASES]


@pytest.mark.parametrize("diagonal,known", CASES, ids=IDS)
def test_full_cov_nll_pme_matches_jax(diagonal, known):
    noisy, mu, a, std = inputs()
    want = jlosses.full_cov_nll_pme(
        jnp.asarray(noisy), jnp.asarray(mu),
        sigma_jax(jnp.asarray(a), diagonal), jnp.asarray(std),
        known_noise=known)
    got = losses.full_cov_nll_pme(
        torch.from_numpy(noisy), torch.from_numpy(mu),
        sigma_torch(torch.from_numpy(a), diagonal), torch.from_numpy(std),
        known_noise=known)
    for name, g, w in zip(("loss", "pme", "net_std", "noise_std"), got, want):
        assert_close(g.numpy(), w, RTOL, name)
    assert got[0].shape == (B, H, W) and got[1].shape == (B, H, W, C)


@pytest.mark.parametrize("diagonal,known", CASES, ids=IDS)
def test_full_cov_gradient_matches_jax_grad(diagonal, known):
    noisy, mu, a, std = inputs(1)

    def jloss(mu_, a_, std_):
        loss = jlosses.full_cov_nll_pme(jnp.asarray(noisy), mu_,
                                        sigma_jax(a_, diagonal), std_,
                                        known_noise=known)[0]
        return jnp.mean(loss)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(mu), jnp.asarray(a), jnp.asarray(std))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (mu, a, std)]
    loss = losses.full_cov_nll_pme(
        torch.from_numpy(noisy), leaves[0], sigma_torch(leaves[1], diagonal),
        leaves[2], known_noise=known)[0]
    torch.mean(loss).backward()
    for name, t, w in zip(("mu", "A", "noise_std"), leaves, want):
        w = np.asarray(w)
        if diagonal and name == "A":
            # Only the leading C entries of A enter a diagonal covariance.
            assert float(np.abs(w[..., C:]).max()) == 0.0
            assert float(t.grad[..., C:].abs().max()) == 0.0
            w, g = w[..., :C], t.grad[..., :C].numpy()
        else:
            g = t.grad.numpy()
        assert rel_l2(g, w) <= GRAD_L2, name


def test_masked_mse_matches_jax():
    rng = np.random.RandomState(2)
    pred, target = (rng.rand(3, 8, 8, 1).astype(np.float32) for _ in range(2))
    mask = (rng.rand(3, 8, 8, 1) < 0.2).astype(np.float32)
    want, jgrad = jax.value_and_grad(
        lambda p: jnp.sum(jlosses.masked_mse(p, jnp.asarray(target),
                                             jnp.asarray(mask)) ** 2))(
        jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_(True)
    got = losses.masked_mse(p, torch.from_numpy(target), torch.from_numpy(mask))
    assert got.shape == (3, 1)
    np.testing.assert_allclose(
        got.detach().numpy(),
        np.asarray(jlosses.masked_mse(jnp.asarray(pred), jnp.asarray(target),
                                      jnp.asarray(mask))), rtol=1e-6)
    torch.sum(got ** 2).backward()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrad), rtol=1e-6,
                               atol=1e-7)
    # Pixels outside the mask get no gradient.
    assert float(p.grad[torch.from_numpy(mask) == 0].abs().max()) == 0.0


def test_mse_per_item_matches_jax():
    rng = np.random.RandomState(3)
    pred, ref = (rng.rand(2, 6, 7, 1).astype(np.float32) for _ in range(2))
    _, jgrad = jax.value_and_grad(
        lambda p: jnp.sum(jlosses.mse_per_item(p, jnp.asarray(ref))))(
        jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_(True)
    got = losses.mse_per_item(p, torch.from_numpy(ref))
    assert got.shape == (2, 1)
    np.testing.assert_allclose(
        got.detach().numpy(),
        np.asarray(jlosses.mse_per_item(jnp.asarray(pred), jnp.asarray(ref))),
        rtol=1e-6)
    torch.sum(got).backward()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrad), rtol=1e-6,
                               atol=1e-8)
