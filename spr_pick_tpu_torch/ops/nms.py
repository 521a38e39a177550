"""Greedy non-maximum suppression: host API, cap retry and the oracle.

PyTorch port of `spr_pick_tpu/ops/nms.py:448-655` (parity:
`spr_pick/utils/algorithms.py:59-103`): descending-score greedy picking
with disk suppression of radius r and a strict score floor; among equal
scores the highest flat index is picked first.

Dispatch: every map goes to K1 (`ops/nms_cuda.py`) — the CUDA kernel for a
CUDA tensor, at any map size, and its plain PyTorch version for a CPU
tensor.  A (B, H, W) batch is one call over the whole batch.  Output is
static-shaped (``max_peaks`` slots plus a count); a list that fills the
buffer is re-run with a doubled cap, up to 4 doublings, then a warning says
picks were dropped.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from spr_pick_tpu_torch.ops.nms_cuda import greedy_nms
from spr_pick_tpu_torch.utils import profiling

logger = logging.getLogger("nms")

# Bounded auto-retry when a pick list hits the static max_peaks buffer:
# doubling 4 times gives a 16x ceiling, after which the truncation warning
# fires.
_MAX_NMS_DOUBLINGS = 4


def _as_maps(heatmaps) -> torch.Tensor:
    t = torch.as_tensor(heatmaps)
    return t if t.dtype == torch.float32 else t.float()


def _warn_if_capped(counts, max_peaks: int) -> None:
    """Flag silent truncation: the reference's host NMS returns every peak
    above the floor; the device buffer holds ``max_peaks``."""
    counts = np.atleast_1d(np.asarray(counts))
    n_capped = int((counts >= max_peaks).sum())
    if n_capped:
        logger.warning(
            "NMS pick list hit the max_peaks cap (%d) on %d of %d map(s); "
            "picks beyond the cap were DROPPED — re-run with a larger "
            "--max_peaks to get the full list",
            max_peaks, n_capped, len(counts),
        )


def nms_batch_device(heatmaps, radius: int, threshold: float = 0.02,
                     max_peaks: int = 2048, suppressed=None):
    """Greedy NMS over a (B, H, W) batch in one call; returns
    (scores, coords, counts) tensors on the heatmaps' device, without
    waiting for them.  ``suppressed``: optional (B, H, W) boolean mask of
    initially-suppressed pixels (the reference's `contam` seeding): they
    can never be picked but do not block picks near them.  Counted as
    ``k1.calls``."""
    profiling.count("k1.calls")
    return greedy_nms(_as_maps(heatmaps), radius, threshold, max_peaks,
                      suppressed)


def nms_batch_trim(scores, coords, counts, heatmaps=None, radius=None,
                   threshold: float = 0.02, suppressed=None):
    """Pull batched-NMS results and trim to per-map (scores, coords) numpy
    pairs.  With ``heatmaps`` and ``radius``, maps whose list filled the
    buffer are re-run with a doubled cap (up to ``_MAX_NMS_DOUBLINGS``
    times); without them the capped lists are kept with a warning.  The
    host waits for the device here (span ``spr.fetch``)."""
    with profiling.span("spr.fetch"):
        counts = counts.cpu().numpy()
        scores = scores.cpu().numpy()
        coords = coords.cpu().numpy()
        max_peaks = scores.shape[-1]
        results = [
            (scores[i, : counts[i]], coords[i, : counts[i]])
            for i in range(scores.shape[0])
        ]
        todo = np.flatnonzero(counts >= max_peaks)
        if todo.size == 0:
            return results
        if heatmaps is None or radius is None:
            _warn_if_capped(counts, max_peaks)
            return results

        hm = _as_maps(heatmaps)
        sup = None if suppressed is None else torch.as_tensor(suppressed)
        cap = max_peaks
        for _ in range(_MAX_NMS_DOUBLINGS):
            prev, cap = cap, cap * 2
            logger.warning(
                "NMS pick list hit the max_peaks cap (%d) on %d of %d map(s); "
                "auto-retrying those maps with max_peaks=%d",
                prev, todo.size, len(counts), cap,
            )
            idx = torch.as_tensor(todo, device=hm.device)
            s2, c2, n2 = nms_batch_device(
                hm.index_select(0, idx), radius, threshold, cap,
                None if sup is None
                else sup.index_select(0, idx.to(sup.device)),
            )
            s2, c2, n2 = s2.cpu().numpy(), c2.cpu().numpy(), n2.cpu().numpy()
            for k, i in enumerate(todo):
                results[i] = (s2[k, : n2[k]], c2[k, : n2[k]])
            todo = todo[n2 >= cap]
            if todo.size == 0:
                return results
        logger.warning(
            "NMS pick list still hit the cap (%d) on %d map(s) after %d "
            "automatic retries; picks beyond the cap were DROPPED — re-run "
            "with a larger --max_peaks to get the full list",
            cap, todo.size, _MAX_NMS_DOUBLINGS,
        )
        return results


def nms_batch_to_host(heatmaps, radius: int, threshold: float = 0.02,
                      max_peaks: int = 2048, suppressed=None):
    """Greedy NMS over a (B, H, W) batch; a list of (scores, coords) numpy
    pairs, with the capped-list retry of `nms_batch_trim`."""
    return nms_batch_trim(
        *nms_batch_device(heatmaps, radius, threshold, max_peaks, suppressed),
        heatmaps=heatmaps, radius=radius, threshold=threshold,
        suppressed=suppressed,
    )


def nms_to_host(heatmap, radius: int, threshold: float = 0.02,
                max_peaks: int = 2048, suppressed=None):
    """Greedy NMS on one (H, W) map -> trimmed numpy (scores, coords as
    (x, y)).  ``suppressed``: optional (H, W) boolean seed mask."""
    sup = None if suppressed is None else torch.as_tensor(suppressed)[None]
    return nms_batch_to_host(
        _as_maps(heatmap)[None], radius, threshold, max_peaks, sup
    )[0]


def non_maximum_suppression_np(x: np.ndarray, r: int, threshold=-np.inf,
                               suppressed=None):
    """Reference-semantics host NMS (the oracle for tests).

    Greedy over descending scores with disk suppression.  A stable sort
    makes ties deterministic (higher flat index first).  ``suppressed``:
    optional (H, W) boolean initial suppression mask (the reference's
    seeded `contam` set, algorithms.py:59-77).
    """
    h, w = x.shape
    flat = x.ravel()
    order = np.argsort(flat, kind="stable")[::-1]
    if suppressed is None:
        suppressed = np.zeros((h, w), dtype=bool)
    else:
        suppressed = np.asarray(suppressed, bool).copy()
    yy, xx = np.mgrid[-r : r + 1, -r : r + 1]
    disk = (yy ** 2 + xx ** 2) <= r * r

    scores, coords = [], []
    for idx in order:
        if flat[idx] <= threshold:
            break
        y, xq = divmod(int(idx), w)
        if suppressed[y, xq]:
            continue
        scores.append(flat[idx])
        coords.append((xq, y))
        y0, y1 = max(0, y - r), min(h, y + r + 1)
        x0, x1 = max(0, xq - r), min(w, xq + r + 1)
        suppressed[y0:y1, x0:x1] |= disk[
            y0 - (y - r) : y1 - (y - r), x0 - (xq - r) : x1 - (xq - r)
        ]
    return (
        np.asarray(scores, np.float32),
        np.asarray(coords, np.int32).reshape(-1, 2),
    )
