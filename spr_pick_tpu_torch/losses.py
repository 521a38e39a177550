"""Loss functions: clamped sigmoid, ssdn NLL/PME (one channel and the
3-channel full covariance), the noise-estimate remap, the PU losses, focal
losses, the JS divergence and the n2c/n2n/n2v mean squared errors.

PyTorch port of `spr_pick_tpu/losses.py` (parity:
`spr_pick/denoiser_v2.py:32-34,209-249,399-402,448-462,778-823` and
`spr_pick/utils/losses.py`).  The reference's dynamic ``N = #unlabeled`` in
the PU generalised-expectation penalty is handled, as in the JAX package,
by masking over a static ``0..B`` count vector, and
``scipy.stats.binom.logpmf`` is re-derived from ``lgamma``.  Masked
branches go through `torch.where`, whose backward sends a zero gradient to
the branch it did not select, so a masked ``-inf`` never reaches a
gradient.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

# Matches the `_sigmoid` clamp at denoiser_v2.py:32-34.
SIGMOID_EPS = 1e-4


def clamped_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.sigmoid(x), SIGMOID_EPS, 1.0 - SIGMOID_EPS)


def gaussian_nll_pme(
    noisy_in: torch.Tensor,
    mu_x: torch.Tensor,
    sigma_x: torch.Tensor,
    noise_std: torch.Tensor,
    known_noise: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-channel Gaussian NLL loss and posterior mean estimate.

    Parity: denoiser_v2.py:448-462 —
      sigma_n = noise_std**2
      sigma_y = sigma_x + sigma_n
      loss    = (y - mu)^2 / sigma_y + log(sigma_y)  [- 0.05 * noise_std]
      pme     = (y * sigma_x + mu * sigma_n) / (sigma_x + sigma_n)

    Returns (loss_map, pme, net_std, noise_std_map).
    """
    sigma_n = noise_std ** 2
    sigma_y = sigma_x + sigma_n
    loss_out = ((noisy_in - mu_x) ** 2) / sigma_y + torch.log(sigma_y)
    pme_out = (noisy_in * sigma_x + mu_x * sigma_n) / (sigma_x + sigma_n)
    net_std_out = torch.sqrt(sigma_x)
    noise_std_out = torch.broadcast_to(noise_std, noisy_in.shape)
    if not known_noise:
        loss_out = loss_out - 0.05 * noise_std  # balance regularisation
    return loss_out, pme_out, net_std_out, noise_std_out


def full_cov_nll_pme(
    noisy_in: torch.Tensor,
    mu_x: torch.Tensor,
    sigma_x: torch.Tensor,
    noise_std: torch.Tensor,
    known_noise: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Multi-channel (3 for RGB) full-covariance NLL and posterior mean.

    Parity: `spr_pick_tpu/losses.py:58-97` (denoiser_v2.py:778-823).
    noisy_in, mu_x: (B, H, W, C); sigma_x: (B, H, W, C, C) = A^T A;
    noise_std: broadcastable to (B, H, W, C), the per-channel s.d.  The
    per-pixel CxC inverses and determinants are float32
    ``torch.linalg`` calls; three inverses take ``+1e-6 I`` and the
    determinants are clipped at 0, as in the JAX package.
    Returns (loss_map (B, H, W), pme (B, H, W, C), net_std, noise_std).
    """
    c = noisy_in.shape[-1]
    eye = torch.eye(c, dtype=noisy_in.dtype, device=noisy_in.device)
    i_eps = eye * 1e-6

    sigma_n = (noise_std ** 2)[..., None] * eye  # BHWCC diagonal
    sigma_y = sigma_x + sigma_n

    sigma_y_inv = torch.linalg.inv(sigma_y)
    diff = noisy_in - mu_x
    vtmv = torch.einsum("...i,...ij,...j->...", diff, sigma_y_inv, diff)
    dets = torch.clamp(torch.linalg.det(sigma_y), min=0.0)
    loss_out = 0.5 * torch.log(dets) + 0.5 * vtmv
    if not known_noise:
        loss_out = loss_out - 0.1 * torch.mean(noise_std, dim=-1)

    sigma_x_inv = torch.linalg.inv(sigma_x + i_eps)
    sigma_n_inv = torch.linalg.inv(sigma_n + i_eps)
    pme_c1 = torch.linalg.inv(sigma_x_inv + sigma_n_inv + i_eps)
    pme_c2 = (torch.einsum("...ij,...j->...i", sigma_x_inv, mu_x)
              + torch.einsum("...ij,...j->...i", sigma_n_inv, noisy_in))
    pme_out = torch.einsum("...ij,...j->...i", pme_c1, pme_c2)

    net_std_out = torch.clamp(torch.linalg.det(sigma_x), min=0.0) ** (1.0 / 6.0)
    noise_std_out = torch.clamp(torch.linalg.det(sigma_n), min=0.0) ** (1.0 / 6.0)
    return loss_out, pme_out, net_std_out, noise_std_out


def softplus_noise_remap(noise_est: torch.Tensor) -> torch.Tensor:
    """softplus(x - 4) + 1e-3 — keeps the noise estimate positive, starting
    near zero.  Parity: denoiser_v2.py:399-402."""
    return F.softplus(noise_est - 4.0) + 1e-3


# ---------------------------------------------------------------------------
# Positive-unlabeled loss with generalised-expectation binomial penalty
# ---------------------------------------------------------------------------

def binom_logpmf(k: torch.Tensor, n: torch.Tensor, p: float) -> torch.Tensor:
    """log Binomial(k; n, p) via lgamma (scipy.stats.binom.logpmf at the
    reference's losses.py:326)."""
    k = k.float()
    n = torch.as_tensor(n, dtype=torch.float32, device=k.device)
    return (
        torch.lgamma(n + 1.0)
        - torch.lgamma(k + 1.0)
        - torch.lgamma(torch.clamp(n - k, min=0.0) + 1.0)
        + k * math.log(p)
        + (n - k) * math.log1p(-p)
    )


def bce(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross entropy on probabilities (nn.BCELoss
    semantics, soft targets allowed)."""
    return -(target * torch.log(pred) + (1.0 - target) * torch.log(1.0 - pred))


def _ge_penalty(q_mu, q_var, n, b: int, tau: float, entropy_penalty: float):
    """-sum_k logBinom(k; n, tau) * softmax_k(-(q_mu - k)^2 / (2 q_var)) over
    k = 0..b, entries k > n masked out of the softmax."""
    k = torch.arange(0, b + 1, dtype=q_mu.dtype, device=q_mu.device)
    valid = k <= n
    logits = -0.5 * (q_mu - k) ** 2 / (q_var + 1e-7)
    logits = torch.where(valid, logits, torch.full_like(logits, -math.inf))
    q_discrete = torch.softmax(logits, dim=0)
    log_binom = torch.where(valid, binom_logpmf(k, n, tau),
                            torch.zeros_like(k))
    ge = -torch.sum(log_binom * q_discrete)
    if entropy_penalty > 0:
        ge = ge + 0.5 * (torch.log(q_var) + math.log(2 * math.pi) + 1.0) \
            * entropy_penalty
    return ge


def _global_sums(mesh, *sums: torch.Tensor):
    """The batch sums a loss couples its items with, over the global batch
    of a data-parallel run (one all-reduce that carries gradients); as
    they are without a mesh."""
    if mesh is None:
        return sums
    return tuple(mesh.global_sum(torch.stack(sums)).unbind())


def pu_loss(pred: torch.Tensor, target: torch.Tensor, tau: float,
            slack: float = 4.0, entropy_penalty: float = 0.0,
            mesh=None) -> torch.Tensor:
    """PU loss: BCE on labeled coords + slack * GE binomial penalty.

    Parity: `spr_pick_tpu/losses.py:130-180` (the reference's `pu_loss`,
    losses.py:303-341, with criteria=BCELoss and slack 4).

      labeled  : y >= 0 -> BCE(pred, y), mean over labeled
      unlabeled: y == -1 -> q_mu = sum p, q_var = sum p(1-p)
                 q_discrete = softmax_k(-(q_mu - k)^2 / (2 q_var)), k = 0..N
                 ge = -sum_k logBinom(k; N, tau) * q_discrete

    With a ``mesh`` (`parallel/mesh.py`) ``pred``/``target`` are this
    rank's rows and every sum runs over the global batch.
    """
    pred = pred.reshape(-1)
    target = target.reshape(-1)
    b = pred.shape[0] * (1 if mesh is None else mesh.size)

    labeled = (target >= 0).to(pred.dtype)
    cls_elem = bce(pred, torch.clamp(target, 0.0, 1.0)) * labeled
    unlabeled = (target == -1).to(pred.dtype)
    p_hat = pred * unlabeled
    cls_sum, n_labeled, q_mu, q_var, n_unlabeled = _global_sums(
        mesh, torch.sum(cls_elem), torch.sum(labeled), torch.sum(p_hat),
        torch.sum(p_hat * (1.0 - p_hat)), torch.sum(unlabeled))
    classifier_loss = torch.where(
        n_labeled > 0,
        cls_sum / torch.clamp(n_labeled, min=1.0),
        torch.zeros_like(n_labeled),
    )
    ge_penalty = _ge_penalty(q_mu, q_var, n_unlabeled, b, tau,
                             entropy_penalty)
    return classifier_loss + slack * ge_penalty


def modified_pu_loss(pred: torch.Tensor, target: torch.Tensor, tau: float,
                     slack: float = 1.0, entropy_penalty: float = 0.0,
                     mesh=None) -> torch.Tensor:
    """Per-patch GE variant: focal classifier on patches containing positives
    + binomial GE over patch-mean scores of all-unlabeled patches.

    Parity: `spr_pick_tpu/losses.py:183-226` (reference losses.py:252-300);
    ``pred``/``target`` are (B, H, W, 1) maps.  With a ``mesh``, this
    rank's rows, and the sums over the global batch.
    """
    b = pred.shape[0]
    t_flat = target.reshape(b, -1)
    p_flat = pred.reshape(b, -1)
    has_pos = (torch.sum(t_flat, dim=1) > 0).to(pred.dtype)

    item_mask = has_pos[:, None]
    cls = _focal_elements(p_flat, t_flat)
    pos_inds = (t_flat == 1).to(pred.dtype) * item_mask
    un_mask = 1.0 - has_pos
    p_mean = torch.mean(p_flat, dim=1) * un_mask
    num_pos, cls_sum, n, q_mu, q_var = _global_sums(
        mesh, torch.sum(pos_inds), torch.sum(cls * item_mask),
        torch.sum(un_mask), torch.sum(p_mean),
        torch.sum(p_mean * (1.0 - p_mean) * un_mask))
    classifier_loss = torch.where(
        num_pos > 0, cls_sum / torch.clamp(num_pos, min=1.0), cls_sum)
    b_global = b * (1 if mesh is None else mesh.size)
    ge = _ge_penalty(q_mu, q_var, n, b_global, tau, entropy_penalty)
    ge = ge / torch.clamp(n, min=1.0)
    return classifier_loss + slack * ge


# ---------------------------------------------------------------------------
# Focal losses (CornerNet style)
# ---------------------------------------------------------------------------

def _focal_elements(pred, gt):
    """Summed CornerNet focal elements (negated, pre-normalisation)."""
    pos_inds = (gt == 1).to(pred.dtype)
    neg_inds = (gt < 1).to(pred.dtype)
    neg_weights = (1.0 - gt) ** 4
    pos_loss = torch.log(pred) * (1.0 - pred) ** 2 * pos_inds
    neg_loss = torch.log(1.0 - pred) * pred ** 2 * neg_weights * neg_inds
    return -(pos_loss + neg_loss)


def focal_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """CornerNet modified focal loss.  Parity: `spr_pick_tpu/losses.py:243-251`
    (reference `_neg_loss`, losses.py:20-60)."""
    pos_inds = (gt == 1).to(pred.dtype)
    neg_inds = (gt < 1).to(pred.dtype)
    neg_weights = (1.0 - gt) ** 4
    pos_loss = torch.sum(torch.log(pred) * (1.0 - pred) ** 2 * pos_inds)
    neg_loss = torch.sum(
        torch.log(1.0 - pred) * pred ** 2 * neg_weights * neg_inds)
    num_pos = torch.sum(pos_inds)
    return torch.where(num_pos == 0, -neg_loss,
                       -(pos_loss + neg_loss) / torch.clamp(num_pos, min=1.0))


def pu_focal_loss(pred: torch.Tensor, gt: torch.Tensor, tau: float,
                  beta: float = 0.0, gamma: float = 1.0,
                  mesh=None) -> torch.Tensor:
    """Focal-style PU risk with soft labels and beta clip.

    Parity: `spr_pick_tpu/losses.py:254-290` (reference `_pu_neg_loss`,
    losses.py:126-184).  With a ``mesh``, this rank's rows, and the sums
    over the global batch.
    """
    true_pos = (gt > 0.5).to(pred.dtype)
    other = (gt < 1).to(pred.dtype)
    soft_pos = (true_pos == other).to(pred.dtype)
    unlabeled = (gt == -1).to(pred.dtype)

    soft_pow_w = (1.0 - gt) ** 4
    soft_pow_neg_w = gt ** 4

    (n_pos, n_soft, n_un, pos_loss, soft_pos_loss, neg_pos_loss, neg_soft,
     unlabeled_sum) = _global_sums(
        mesh, torch.sum(true_pos), torch.sum(soft_pos), torch.sum(unlabeled),
        torch.sum(torch.log(pred) * (1.0 - pred) ** 2 * true_pos),
        torch.sum(torch.log(1.0 - pred) * pred ** 2 * soft_pow_w * soft_pos),
        torch.sum(torch.log(1.0 - pred) * pred ** 2 * true_pos),
        torch.sum(torch.log(pred) * (1.0 - pred) ** 2 * soft_pow_neg_w
                  * soft_pos),
        torch.sum(pred ** 2 * torch.log(1.0 - pred) * unlabeled))
    num_pos = torch.clamp(n_pos, min=1.0)
    num_soft = torch.clamp(n_soft, min=1.0)
    num_un = torch.clamp(n_un, min=1.0)

    pos_risk = (-pos_loss / num_pos - soft_pos_loss / num_soft) * tau
    neg_pos_risk = -neg_pos_loss / num_pos - neg_soft / num_soft

    unlabeled_loss = -unlabeled_sum
    neg_risk_total = -tau * neg_pos_risk + unlabeled_loss / num_un
    return torch.where(neg_risk_total < -beta, pos_risk,
                       pos_risk + neg_risk_total)


# ---------------------------------------------------------------------------
# JS divergence over heatmaps
# ---------------------------------------------------------------------------

def _kl_div_2d(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    # D_KL(P || Q), inputs BHWC treated as (B*C, H*W) distributions.
    b, c = p.shape[0], p.shape[-1]
    pf = torch.movedim(p, -1, 1).reshape(b * c, -1)
    qf = torch.movedim(q, -1, 1).reshape(b * c, -1)
    kl = pf * (torch.log(pf) - torch.log(qf))
    return torch.sum(kl, dim=-1).reshape(b, c)


def js_div_loss_2d(inp: torch.Tensor, target: torch.Tensor,
                   reduction: str = "mean") -> torch.Tensor:
    """Jensen-Shannon divergence between heatmaps.  Parity:
    `spr_pick_tpu/losses.py:307-317` (the reference computes
    JSD(target||input), losses.py:200-248)."""
    p, q = target, inp
    m = 0.5 * (p + q)
    js = 0.5 * _kl_div_2d(p, m) + 0.5 * _kl_div_2d(q, m)
    if reduction == "none":
        return js
    return torch.mean(js) if reduction == "mean" else torch.sum(js)


# ---------------------------------------------------------------------------
# n2c / n2n / n2v mean squared errors
# ---------------------------------------------------------------------------

def masked_mse(pred: torch.Tensor, target: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Squared error on the masked (UPS-manipulated) pixels, summed per
    item -> (B, 1).  Parity: `spr_pick_tpu/losses.py:324-334` (the dense 0/1
    mask of the reference's coordinate list, n2v_loss.py:6-17)."""
    sq = (target - pred) ** 2 * mask
    return torch.sum(sq.reshape(sq.shape[0], -1), dim=1, keepdim=True)


def mse_per_item(pred: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per-item mean squared error -> (B, 1) (n2c/n2n).  Parity:
    `spr_pick_tpu/losses.py:337-340` (denoiser_v2.py:209-226)."""
    sq = (pred - ref) ** 2
    return torch.mean(sq.reshape(sq.shape[0], -1), dim=1, keepdim=True)
