"""Pick-quality metrics and contamination detection, in numpy.

The PyTorch port's copy of `spr_pick_tpu/ops/algorithms.py` (parity:
`spr_pick/utils/algorithms.py:7-58`): `match_coordinates` is the Hungarian
assignment of predicted to true particle coordinates within a radius (scipy,
imported when called), `precision_recall_f1` summarises it, and
`find_contamination` marks pixels whose blurred intensity leaves the -1.5 /
+2 sigma band, dilated by a disk, as a dense 0/1 mask that NMS takes as its
initially suppressed set.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def match_coordinates(targets: np.ndarray, preds: np.ndarray, radius: float
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Hungarian assignment of predictions to targets within `radius`.

    Returns (assignment 0/1 per pred, distance per matched pred): scipy's
    linear_sum_assignment on the squared distance less radius^2, clipped at
    0, so a pair farther than `radius` costs nothing and counts as no match.
    """
    from scipy.optimize import linear_sum_assignment

    if len(preds) == 0 or len(targets) == 0:
        return np.zeros(len(preds), np.float32), np.zeros(len(preds))

    d2 = np.sum((preds[:, np.newaxis] - targets[np.newaxis]) ** 2, 2)
    cost = d2 - radius * radius
    cost[cost > 0] = 0

    pred_index, target_index = linear_sum_assignment(cost)
    matched_cost = cost[pred_index, target_index]
    dist = np.zeros(len(preds))
    dist[pred_index] = np.sqrt(d2[pred_index, target_index])

    pred_index = pred_index[matched_cost < 0]
    assignment = np.zeros(len(preds), dtype=np.float32)
    assignment[pred_index] = 1
    return assignment, dist


def precision_recall_f1(targets: np.ndarray, preds: np.ndarray, radius: float
                        ) -> Tuple[float, float, float]:
    """(precision, recall, F1) of `preds` against `targets` through
    `match_coordinates`; no predictions score (0, 0, 0)."""
    if len(preds) == 0:
        return 0.0, 0.0, 0.0
    assignment, _ = match_coordinates(targets, preds, radius)
    tp = float(assignment.sum())
    precision = tp / len(preds)
    recall = tp / max(len(targets), 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-12)
    return precision, recall, f1


def _box_blur(img: np.ndarray, k: int = 5) -> np.ndarray:
    """Separable box blur (replaces cv2.blur)."""
    pad = k // 2
    padded = np.pad(img.astype(np.float32), pad, mode="edge")
    kernel = np.ones(k, np.float32) / k
    out = np.apply_along_axis(lambda r: np.convolve(r, kernel, "valid"), 1, padded)
    return np.apply_along_axis(lambda c: np.convolve(c, kernel, "valid"), 0, out)


def find_contamination(out_img: np.ndarray, radius: int = 15) -> np.ndarray:
    """Contamination mask: blurred intensity < mean - 1.5 sigma or > mean +
    2 sigma on the min-max 8-bit normalised image, dilated by a disk of
    `radius`."""
    x = out_img.astype(np.float32)
    lo, hi = x.min(), x.max()
    x8 = (x - lo) / (hi - lo) * 255 if hi > lo else np.zeros_like(x)
    blur = _box_blur(x8[3:-3, 3:-3], 5)
    avg, std = x8.mean(), x8.std()

    seeds = (blur < avg - 1.5 * std) | (blur > avg + 2 * std)
    mask = np.zeros_like(x8, dtype=bool)
    if seeds.any():
        ys, xs = np.nonzero(seeds)
        ys, xs = ys + 3, xs + 3  # undo the blur crop offset
        h, w = x8.shape
        yy, xx = np.mgrid[-radius : radius + 1, -radius : radius + 1]
        disk = (yy ** 2 + xx ** 2) <= radius * radius
        for y, xq in zip(ys, xs):
            y0, y1 = max(0, y - radius), min(h, y + radius + 1)
            x0, x1 = max(0, xq - radius), min(w, xq + radius + 1)
            mask[y0:y1, x0:x1] |= disk[
                y0 - (y - radius) : y1 - (y - radius),
                x0 - (xq - radius) : x1 - (xq - radius),
            ]
    return mask.astype(np.uint8)
