"""Halo-overlap spatial tiling for whole-micrograph dense inference.

The PyTorch port of `spr_pick_tpu/parallel/tiling.py:40-296`.  A micrograph
too large for one dense forward is split into fixed-size tiles with a halo
wide enough to cover the U-Net + detector context; the same dense model
runs on each window and the valid centres are stitched back together.

Edge-tile windows are CLAMPED inside the image (shifted tiles), never
zero-filled past it — see `extract_tiles` for why that is load-bearing for
boundary exactness.

Unlike the JAX package, windows, forward outputs and stitched maps stay
torch tensors on the image's device: stitching is a copy, so the numbers are
the same, and the stitched heatmap reaches the NMS kernel without a host
round trip.  Windows can be dealt over several cards (`tiled_dense_apply`
with one apply function a card); no collective is involved.
"""

from __future__ import annotations

import logging
import math
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

logger = logging.getLogger("tiling")

ApplyFn = Callable[[torch.Tensor], Dict[str, torch.Tensor]]


def plan_tiles(h: int, w: int, tile: int) -> Tuple[int, int]:
    return math.ceil(h / tile), math.ceil(w / tile)


def _min_truncation_context(extent: int, tile: int, halo: int) -> float:
    """Smallest one-sided context any tile's valid centre gets at a window
    edge that truncates real image content, along one axis of `extent`.

    Mirrors extract_tiles' clamped-window arithmetic exactly.  A window
    edge that coincides with the image edge truncates nothing (the direct
    forward ends there too), so it does not count.  Returns inf when no
    window edge lies strictly inside the image (single degenerate tile)."""
    n = math.ceil(extent / tile)
    win = min(tile + 2 * halo, extent)
    m = math.inf
    for i in range(n):
        lo = min(max(i * tile - halo, 0), extent - win)
        c_lo, c_hi = i * tile, min((i + 1) * tile, extent)
        if c_lo > 0 and lo > 0:
            m = min(m, c_lo - lo)
        if c_hi < extent and lo + win < extent:
            m = min(m, lo + win - c_hi)
    return m


def usable_halos(shape: Tuple[int, int], tile: int, halos) -> Tuple[int, ...]:
    """Candidate halos a probe of `shape` can SOUNDLY certify for `tile`.

    Certifying halo h from a probe is sound only when the probe geometry
    contains a window edge whose one-sided context is <= h: production
    interior tiles get exactly h of context per side, so the probe must
    measure a truncation at least that severe.  Clamped probe windows can
    instead overlap so much that every boundary sees >= 2h of context —
    then the measured deviation UNDERSTATES production and calibration
    would certify halos ~2x too small."""
    h_, w_ = shape
    return tuple(
        h
        for h in sorted(set(halos))
        if min(
            _min_truncation_context(h_, tile, h),
            _min_truncation_context(w_, tile, h),
        )
        <= h
    )


def extract_tiles(image: torch.Tensor, tile: int, halo: int
                  ) -> Tuple[torch.Tensor, Tuple[int, int], np.ndarray]:
    """(H, W) -> (T, win_y, win_x) overlapping windows, entirely in-image.

    Window positions are CLAMPED to the image extent (shifted tiles) rather
    than zero-filled beyond it.  This is load-bearing for boundary
    exactness: a CNN's implicit zero padding stays zero at EVERY layer,
    but an explicit zero-filled halo does not — the first conv's bias
    turns it into nonzero "hallucinated" features that leak back into the
    valid centre, so edge tiles would disagree with the direct (un-tiled)
    forward in an ~RF/2 border band no matter how wide the halo.  With
    clamped windows the window edge coincides with the image edge, the
    network's implicit padding happens at the true boundary, and tiled ==
    direct everywhere up to halo context decay.

    Returns (tiles on the image's device, (ny, nx), offsets) where
    offsets[k] = (oy, ox) is the position of tile k's valid centre within
    its window (== halo for interior tiles, smaller/larger where the window
    was clamped).
    """
    h, w = image.shape
    ny, nx = plan_tiles(h, w, tile)
    win_y = min(tile + 2 * halo, h)
    win_x = min(tile + 2 * halo, w)
    tiles = image.new_empty((ny * nx, win_y, win_x))
    offsets = np.empty((ny * nx, 2), np.int64)
    k = 0
    for iy in range(ny):
        wy = min(max(iy * tile - halo, 0), h - win_y)
        for ix in range(nx):
            wx = min(max(ix * tile - halo, 0), w - win_x)
            tiles[k] = image[wy : wy + win_y, wx : wx + win_x]
            offsets[k] = (iy * tile - wy, ix * tile - wx)
            k += 1
    return tiles, (ny, nx), offsets


def _centre(grid: Tuple[int, int], tile: int, out_shape: Tuple[int, int],
            k: int):
    """(output slice, size) of tile k's valid centre."""
    iy, ix = divmod(k, grid[1])
    sy = min(tile, out_shape[0] - iy * tile)
    sx = min(tile, out_shape[1] - ix * tile)
    return (slice(iy * tile, iy * tile + sy),
            slice(ix * tile, ix * tile + sx)), (sy, sx)


def _stitch_into(out: torch.Tensor, tile_out: torch.Tensor, k: int,
                 grid, tile: int, offsets: np.ndarray) -> None:
    (ys, xs), (sy, sx) = _centre(grid, tile, out.shape, k)
    oy, ox = (int(v) for v in offsets[k])
    out[ys, xs] = tile_out[oy : oy + sy, ox : ox + sx]


def stitch_tiles(tiles: torch.Tensor, grid: Tuple[int, int], tile: int,
                 offsets: np.ndarray, out_shape: Tuple[int, int]
                 ) -> torch.Tensor:
    """(T, win_y, win_x) valid-centre crops -> (H, W)."""
    out = tiles.new_empty(out_shape)
    for k in range(grid[0] * grid[1]):
        _stitch_into(out, tiles[k], k, grid, tile, offsets)
    return out


def _aligned_halo(h: int, w: int, tile: int, halo: int, align: int) -> int:
    """The halo, widened until interior windows align to ``align``."""
    win = tile + 2 * halo
    if align <= 1 or win >= max(h, w) or win % align == 0:
        return halo
    # Interior windows must be aligned BY CONSTRUCTION: padding them with
    # zeros mid-image would reintroduce the hallucinated-halo bug documented
    # in extract_tiles.  Widen the halo to the next aligning value — extra
    # context is always safe.
    bumped = next(
        (b for b in range(halo + 1, halo + align + 1)
         if (tile + 2 * b) % align == 0),
        None,
    )
    if bumped is None:
        raise ValueError(
            f"tile={tile} with align={align} admits no aligned window for "
            f"any halo >= {halo}; use an even tile multiple of {align}"
        )
    logger.debug("halo %d widened to %d so windows align to %d",
                 halo, bumped, align)
    return bumped


def tiled_dense_apply(apply_tiles: Union[ApplyFn, Sequence[ApplyFn]],
                      image: torch.Tensor, tile: int = 1024, halo: int = 96,
                      max_batch: Optional[int] = None,
                      align: int = 1) -> Dict[str, torch.Tensor]:
    """Run a dense per-pixel model over a large micrograph by tiles.

    ``apply_tiles(batch (B, H, W, 1)) -> {name: (B, H, W, 1)}`` must be
    shape-preserving (dense mode).  ``image`` is an (H, W) tensor; windows
    run ``max_batch`` at a time (default one) on its device, and each
    output's valid centres are copied into an (H, W) map there as the chunk
    returns.  ``align`` pads windows up to a multiple (the dense U-Net route
    needs 32) when a clamped window is not already aligned.

    A list of apply functions (one a card, each with its replica of the
    model: the counterpart of the JAX package's ``mesh=``) deals the chunks
    round-robin: each round launches one chunk on every card, in chunk
    order, then stitches their outputs on the image's device.  The chunks
    and their order are those of one function, so the stitched maps are
    too.
    """
    fns = [apply_tiles] if callable(apply_tiles) else list(apply_tiles)
    h, w = image.shape
    halo = _aligned_halo(h, w, tile, halo, align)
    tiles, grid, offsets = extract_tiles(image.float(), tile, halo)
    t = tiles.shape[0]

    # Windows clamped to the FULL image extent in a dimension (image
    # smaller than tile+2*halo there) may still be unaligned; zero-pad
    # those at bottom/right and crop after — the pad then sits at the true
    # image edge, exactly where (and how) the direct whole-image path pads
    # to 32, so boundary semantics stay consistent.
    win_y, win_x = tiles.shape[1:]
    pad_y = (-win_y) % align
    pad_x = (-win_x) % align
    if pad_y or pad_x:
        tiles = torch.nn.functional.pad(tiles, (0, pad_x, 0, pad_y))

    batch = max(max_batch or 1, 1)
    # Pad the tile count to a multiple of the batch (every forward the same
    # shape) by repeating the last window; its outputs are dropped.
    t_pad = math.ceil(t / batch) * batch
    if t_pad != t:
        tiles = torch.cat([tiles, tiles[-1:].expand(t_pad - t, -1, -1)])

    stitched: Dict[str, torch.Tensor] = {}
    starts = list(range(0, t_pad, batch))
    for r in range(0, len(starts), len(fns)):
        launched = [(i, fn(tiles[i : i + batch, :, :, None]))
                    for i, fn in zip(starts[r : r + len(fns)], fns)]
        for i, out in launched:
            for name, val in out.items():
                val = val.to(image.device)
                if name not in stitched:
                    stitched[name] = val.new_empty((h, w))
                for j in range(min(batch, t - i)):
                    _stitch_into(stitched[name], val[j, :win_y, :win_x, 0],
                                 i + j, grid, tile, offsets)
    return stitched


def _percentile(x: torch.Tensor, q: float) -> float:
    """numpy's default (linear) percentile of all of ``x``."""
    v = x.flatten().double().sort().values
    pos = q / 100.0 * (v.numel() - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, v.numel() - 1)
    return float(v[lo] + (v[hi] - v[lo]) * (pos - lo))


def calibrate_halo(apply_tiles: ApplyFn, probe: torch.Tensor,
                   tile: int = 1024, tol: float = 0.02,
                   percentile: float = 99.0,
                   halos: Tuple[int, ...] = (32, 64, 96, 128, 160, 224, 320),
                   align: int = 1) -> Tuple[int, Dict[int, float]]:
    """Derive the smallest sufficient halo from the MEASURED context decay.

    The blind-spot U-Net's vertical receptive field is unbounded (shifted
    convs accumulate downward context), so no fixed halo is provably
    sufficient for every weight set.  Instead of an analytic bound, run the
    probe both directly and tiled at increasing halos and return the first
    whose outputs agree within `tol` at `percentile` (max over the apply
    fn's returned maps).

    A halo h is only a sound candidate when the probe geometry contains a
    window edge truncating real content with one-sided context <= h
    (`usable_halos`).  The certificate itself is tile-size independent —
    per-pixel deviation is a function of the distance to the truncating
    edge, not of the tile size — so calibrating with a SMALLER tile than
    production is valid.  Returns (halo, {halo: measured deviation}).
    Raises ValueError when the probe is too small or no candidate meets
    `tol` (the measured curve rides on the error as ``.curve``).
    """
    probe = probe.float()
    direct = {
        k: v[0, :, :, 0]
        for k, v in apply_tiles(probe[None, :, :, None]).items()
    }
    usable = usable_halos(tuple(probe.shape), tile, halos)
    if not usable:
        raise ValueError(
            f"probe {tuple(probe.shape)} too small to soundly calibrate "
            f"tile={tile}: no candidate halo in {sorted(set(halos))} has a "
            "window edge with <= halo context (use a larger probe or a "
            "smaller calibration tile)"
        )
    curve: Dict[int, float] = {}
    for halo in usable:
        tiled = tiled_dense_apply(apply_tiles, probe, tile=tile, halo=halo,
                                  align=align)
        curve[halo] = max(
            _percentile((tiled[k] - direct[k]).abs(), percentile)
            for k in direct
        )
        if curve[halo] <= tol:
            return halo, curve
    err = ValueError(
        f"no candidate halo meets tol={tol} at p{percentile:g}: {curve} — "
        "widen `halos` or lower the tile threshold for this model"
    )
    err.curve = curve  # callers can inspect the measured decay
    raise err
