"""The evaluation terms of the losses: clamped sigmoid, ssdn NLL/PME and
the noise-estimate remap.

PyTorch port of `spr_pick_tpu/losses.py:18-55,100-103` (parity:
`spr_pick/denoiser_v2.py:32-34,399-402,448-462`).  The PU, focal and
full-covariance losses belong to the training slice.
"""

from __future__ import annotations

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


def softplus_noise_remap(noise_est: torch.Tensor) -> torch.Tensor:
    """softplus(x - 4) + 1e-3 — keeps the noise estimate positive, starting
    near zero.  Parity: denoiser_v2.py:399-402."""
    return F.softplus(noise_est - 4.0) + 1e-3
