"""Pad-to-multiple and unpad for whole-micrograph inference.

The PyTorch port's copy of `spr_pick_tpu/data/micrograph.py:62-107`
(parity: `spr_pick/datasets/image_wrapper.py:221-276`).  The rest of that
module is the training data plane, which belongs to a later slice.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def pad_to_multiple(img: np.ndarray, multiple: int,
                    square: bool = False) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Reflection-pad H,W (trailing sides) up to a multiple.

    Parity: image_wrapper.py:221-249 (left/top 0, right/bottom padded).
    ``square=True`` additionally pads the shorter side to the longer one
    (the blind-spot rot4 fold needs H == W).  Returns
    (padded, original_shape).
    """
    h, w = img.shape[:2]
    ph = (h + multiple - 1) // multiple * multiple
    pw = (w + multiple - 1) // multiple * multiple
    if square:
        ph = pw = max(ph, pw)
    if ph == h and pw == w:
        return img, (h, w)
    return _reflect_pad_trailing(img, ph - h, pw - w), (h, w)


def _reflect_pad_trailing(img: np.ndarray, ph: int, pw: int) -> np.ndarray:
    """Reflection-pad the trailing H/W sides by (ph, pw).

    np.pad(mode="reflect") requires pad < dim; square-padding a
    rectangular micrograph with aspect ratio >= 2 violates that, so the
    pad is applied in passes (each bounded by dim-1).  Degenerate 1-px
    dims fall back to edge replication (reflect is undefined there).
    """
    while ph > 0 or pw > 0:
        h, w = img.shape[:2]
        if (ph > 0 and h <= 1) or (pw > 0 and w <= 1):
            pad = [(0, ph), (0, pw)] + [(0, 0)] * (img.ndim - 2)
            return np.pad(img, pad, mode="edge")
        dh = min(ph, h - 1)
        dw = min(pw, w - 1)
        pad = [(0, dh), (0, dw)] + [(0, 0)] * (img.ndim - 2)
        img = np.pad(img, pad, mode="reflect")
        ph -= dh
        pw -= dw
    return img


def unpad(img: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    """Crop back to the original (H, W).  Parity: image_wrapper.py:251-276."""
    return img[: shape[0], : shape[1]]
