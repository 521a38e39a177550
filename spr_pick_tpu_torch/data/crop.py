"""Labeled-area-constrained random crop.

The PyTorch port's copy of `spr_pick_tpu/data/crop.py` (parity:
`spr_pick/utils/crop.py`, MyRandomCrop): crop a patch whose centre region
holds labeled pixels when `labeled_only` is set, with reflect padding for
undersized images; returns the centre label too (SURVEY.md §7.4).  Numpy,
the same draws from the same `RandomState` as the JAX package's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def random_crop(
    img: np.ndarray,
    hm: Optional[np.ndarray],
    size: int,
    rng: np.random.RandomState,
    labeled_only: bool = False,
    pad_if_needed: bool = True,
    padding_mode: str = "reflect",
    max_tries: int = 16,
) -> Tuple[np.ndarray, Optional[np.ndarray], float]:
    """Crop `size`x`size` from img (H, W) [+ aligned heatmap crop].

    Returns (img_crop, hm_crop, centre_label).
    """
    h, w = img.shape[:2]
    if pad_if_needed and (h < size or w < size):
        ph, pw = max(0, size - h), max(0, size - w)
        img = np.pad(img, ((0, ph), (0, pw)), mode=padding_mode)
        if hm is not None:
            hm = np.pad(hm, ((0, ph), (0, pw)), mode=padding_mode)
        h, w = img.shape[:2]

    def crop_at(y0, x0):
        ic = img[y0 : y0 + size, x0 : x0 + size]
        hc = hm[y0 : y0 + size, x0 : x0 + size] if hm is not None else None
        return ic, hc

    for _ in range(max_tries):
        y0 = rng.randint(0, h - size + 1)
        x0 = rng.randint(0, w - size + 1)
        ic, hc = crop_at(y0, x0)
        if not labeled_only or hm is None:
            break
        if (hc > 0).any():
            break
    label = float(hc[size // 2, size // 2]) if hc is not None else -1.0
    return ic, hc, label
