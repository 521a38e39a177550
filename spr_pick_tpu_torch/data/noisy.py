"""Algorithm-dependent input/reference preparation (the NoisyDataset role).

The PyTorch port's copy of `spr_pick_tpu/data/noisy.py` (parity:
`spr_pick/datasets/noise_wrapper.py:98-168`, prepare_input):

  * input  = image (the reference disables synthetic input noise at
    noise_wrapper.py:123 — cryo-EM data is already noisy; ``noise_input``
    enables it for clean benchmark datasets),
  * n2c    -> ref = clean image,
  * n2n    -> ref = image + synthetic noise (noise_style DSL),
  * n2v    -> input = UPS-manipulated image, ref = image + noise, mask map,
  * ssdn   -> no reference,
  * ssdn_u_only -> ref = input.

`prepare_batch` is the numpy host plane (the JAX package's draws from the
same `RandomState`); `prepare_batch_torch` is `prepare_batch_jax` on the
device, its draws from a `torch.Generator`.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from spr_pick_tpu_torch.data import n2v as n2v_mod
from spr_pick_tpu_torch.data.noise import add_style, add_style_torch
from spr_pick_tpu_torch.params import NoiseAlgorithm


def prepare_batch(
    images: np.ndarray,
    algorithm: NoiseAlgorithm,
    noise_style: Optional[str],
    rng: np.random.RandomState,
    training: bool = True,
    noise_input: bool = False,
) -> Dict[str, np.ndarray]:
    """images: (B, H, W) float32 in [0,1].  Returns NHWC batch dict with
    'inp' and optionally 'ref'/'mask'/'noise_std'."""
    clean = np.asarray(images, np.float32)
    if noise_input and noise_style:
        noisy_in, coeff = add_style(clean, noise_style, rng=rng)
    else:
        noisy_in, coeff = clean, None

    batch: Dict[str, np.ndarray] = {}
    mask = None

    if algorithm == NoiseAlgorithm.NOISE_TO_VOID and training:
        manipulated = np.empty_like(noisy_in)
        mask = np.zeros_like(noisy_in)
        for b in range(noisy_in.shape[0]):
            manipulated[b], mask[b] = n2v_mod.manipulate(noisy_in[b], 5,
                                                         rng=rng)
        noisy_in = manipulated

    if algorithm == NoiseAlgorithm.NOISE_TO_CLEAN:
        ref = clean
    elif algorithm in (NoiseAlgorithm.NOISE_TO_NOISE,
                       NoiseAlgorithm.NOISE_TO_VOID):
        ref, _ = add_style(clean, noise_style, rng=rng)
    elif algorithm == NoiseAlgorithm.SELFSUPERVISED_DENOISING:
        ref = None
    elif algorithm == NoiseAlgorithm.SELFSUPERVISED_DENOISING_MEAN_ONLY:
        ref = noisy_in
    else:
        raise NotImplementedError("Denoising algorithm not supported")

    batch["inp"] = noisy_in[..., None]
    if ref is not None:
        batch["ref"] = ref[..., None]
    if mask is not None:
        batch["mask"] = mask[..., None]
    if coeff is not None:
        # Fixed styles ("gauss25", "poisson30") give one scalar for the
        # batch, a Python int for a fixed poisson lam included: broadcast
        # it to the per-item (B, 1, 1, 1) layout.
        coeff_arr = np.asarray(coeff, np.float32)
        if coeff_arr.ndim == 0:
            coeff_arr = np.full((clean.shape[0],), float(coeff_arr),
                                np.float32)
        batch["noise_std"] = coeff_arr.reshape(clean.shape[0], 1, 1, 1)
    return batch


def prepare_batch_torch(
    crops: torch.Tensor,
    algorithm: NoiseAlgorithm,
    noise_style: Optional[str],
    generator: Optional[torch.Generator] = None,
    training: bool = True,
    noise_input: bool = False,
) -> Dict[str, torch.Tensor]:
    """`prepare_batch` on the device (`prepare_batch_jax`): the same
    algorithm matrix on (B, H, W) crops, every draw from ``generator`` in
    the order input noise, UPS, reference noise."""
    clean = crops
    coeff = None
    if noise_input and noise_style:
        noisy_in, coeff = add_style_torch(clean, noise_style, generator)
    else:
        noisy_in = clean

    batch: Dict[str, torch.Tensor] = {}
    mask = None
    if algorithm == NoiseAlgorithm.NOISE_TO_VOID and training:
        noisy_in, mask = n2v_mod.manipulate_torch(noisy_in,
                                                  generator=generator)

    if algorithm == NoiseAlgorithm.NOISE_TO_CLEAN:
        ref = clean
    elif algorithm in (NoiseAlgorithm.NOISE_TO_NOISE,
                       NoiseAlgorithm.NOISE_TO_VOID):
        ref, _ = add_style_torch(clean, noise_style, generator)
    elif algorithm == NoiseAlgorithm.SELFSUPERVISED_DENOISING:
        ref = None
    elif algorithm == NoiseAlgorithm.SELFSUPERVISED_DENOISING_MEAN_ONLY:
        ref = noisy_in
    else:
        raise NotImplementedError("Denoising algorithm not supported")

    batch["inp"] = noisy_in[..., None]
    if ref is not None:
        batch["ref"] = ref[..., None]
    if mask is not None:
        batch["mask"] = mask[..., None]
    if coeff is not None:
        batch["noise_std"] = coeff.reshape(clean.shape[0], 1, 1, 1)
    return batch
