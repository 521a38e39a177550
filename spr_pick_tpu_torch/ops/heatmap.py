"""Particle-coordinate -> heatmap/mask rasterisation, in numpy.

The PyTorch port's copy of `spr_pick_tpu/ops/heatmap.py` (parity:
`spr_pick/utils/coordinates.py:6-154`): CornerNet min-overlap-0.7 radius,
per-peak max-composition, background value -1.  The JAX package can hand
`as_gaussian` to a C++ rasteriser built with g++; the port keeps the numpy
loop, which that rasteriser equals within 1e-6 (one float32 ulp of some
values; tests/test_native.py, tests/test_torch_patch_pipeline.py).
"""

from __future__ import annotations

import numpy as np


def gaussian_radius(det_size, min_overlap: float = 0.7) -> float:
    """CornerNet radius so any corner within r keeps IoU >= min_overlap."""
    height, width = det_size

    a1 = 1.0
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + np.sqrt(b1 ** 2 - 4 * a1 * c1)) / 2

    a2 = 4.0
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + np.sqrt(b2 ** 2 - 4 * a2 * c2)) / 2

    a3 = 4.0 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + np.sqrt(b3 ** 2 - 4 * a3 * c3)) / 2
    return min(r1, r2, r3)


def gaussian_2d(shape, sigma: float = 1.0) -> np.ndarray:
    """2-D un-normalised Gaussian bump; tiny values zeroed."""
    m, n = [(s - 1.0) / 2.0 for s in shape]
    y = np.arange(-m, m + 1)[:, None]
    x = np.arange(-n, n + 1)[None, :]
    h = np.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    h[h < np.finfo(h.dtype).eps * h.max()] = 0
    return h


def draw_gaussian(heatmap: np.ndarray, center, radius: int, k: float = 1.0):
    """Max-compose a Gaussian bump into `heatmap` at `center` (x, y)."""
    diameter = 2 * radius + 1
    gaussian = gaussian_2d((diameter, diameter), sigma=diameter / 6)

    x, y = int(center[0]), int(center[1])
    height, width = heatmap.shape[:2]

    left, right = min(x, radius), min(width - x, radius + 1)
    top, bottom = min(y, radius), min(height - y, radius + 1)

    if right + left <= 0 or bottom + top <= 0:
        return heatmap
    roi = heatmap[y - top : y + bottom, x - left : x + right]
    g = gaussian[radius - top : radius + bottom, radius - left : radius + right]
    if roi.size > 0 and g.size > 0:
        np.maximum(roi, g * k, out=roi)
    return heatmap


def as_gaussian(shape, x_coord, y_coord, bb: int = 36) -> np.ndarray:
    """Heatmap initialised to -1, peaks at 1, CornerNet radius from bb."""
    hm = np.full(shape, -1.0, dtype=np.float32)
    radius = max(0, int(gaussian_radius((bb, bb))))
    for x, y in zip(np.asarray(x_coord, np.int32), np.asarray(y_coord, np.int32)):
        draw_gaussian(hm, (x, y), radius)
    return hm


def as_mask(shape, x_coord, y_coord, radii) -> np.ndarray:
    """Binary disk mask over particle coordinates, each disk rasterised into
    its bounding box only."""
    mask = np.zeros(shape, dtype=np.uint8)
    h, w = shape
    for x, y, r in zip(np.asarray(x_coord), np.asarray(y_coord),
                       np.asarray(radii)):
        r = int(r)
        x0, x1 = max(0, int(x) - r), min(w, int(x) + r + 1)
        y0, y1 = max(0, int(y) - r), min(h, int(y) + r + 1)
        if x1 <= x0 or y1 <= y0:
            continue
        yy = np.arange(y0, y1)[:, None] - y
        xx = np.arange(x0, x1)[None, :] - x
        disk = (xx * xx + yy * yy) <= r * r
        np.maximum(mask[y0:y1, x0:x1], disk.astype(np.uint8),
                   out=mask[y0:y1, x0:x1])
    return mask
