"""Entry ``pick_tiled``: `Picker.pick_many_table([path])` of a frame above
the evaluator's tiling threshold, one frame a request: the MRC read and
decoded on the host, halo tiling (windows of ``tile`` + 2 ``halo`` px
clamped inside the frame, one dense forward each with its own sample
noise, their centres stitched on the device), K1 on the stitched map
(with its cap retries), the border filter and the table.  Judged against
the plain reference map computed window by window as the mix plans them
(a whole-frame float32 pass does not fit on the card), with the numbers
of `entries/pick.py`.  The functions an entry gives are listed there.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from gpubench import data, program
from gpubench.entries import pick
from gpubench.reference import model as ref
from gpubench.requests import mic_metrics

TINY = pick.TINY
EXACT = pick.EXACT
CALIBRATION_WINDOW = 1024   # the detector's statistics are set on this


call = pick.call
size = pick.size


def prepare(cell, seed: int, device, tmp: str) -> program.Prepared:
    """`program.prepare_picker`'s set-up, with the detector's statistics
    set on the top-left 1024^2 window of the pool's first decoded frame
    (a float32 pass over the whole frame does not fit on the card)."""
    config, model = cell.config, cell.config["model"]
    ref.precisions(config)               # refuse a precision with no judge
    weights = ref.make_weights(model, seed, device)
    raws = data.pool(seed, cell.traffic)
    n = CALIBRATION_WINDOW
    img = ref.decoded(raws[0], device)[:n, :n].contiguous()
    ref.calibrate(weights, model, img,
                  program.sample_noise(img.shape, seed, device),
                  config["cfg"]["NMS"], config["pick"]["threshold"])
    del img
    if torch.device(device).type == "cuda":
        # The peak the run reports is the program's, not set-up's.
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    wt = os.path.join(tmp, "model.wt")
    program.write_checkpoint(config, weights, wt, device)
    paths = data.write_pool(raws, tmp)
    return program.Prepared(int(seed), weights, raws, paths,
                            program.open_picker(config, wt, seed, device))


def end_to_end(latencies, sizes, window_s: float, err) -> Dict[str, float]:
    return mic_metrics(latencies, sizes, window_s, err)


def windows(h: int, w: int, tile: int, halo: int
            ) -> Iterator[Tuple[int, int, int, int, int]]:
    """(top, left, window edge, centre row, centre column) of each window
    in row-major order: ``tile`` px centres on a grid from the frame's
    corner, each window ``tile`` + 2 ``halo`` px a side, shifted inside
    the frame where it would cross an edge."""
    win = tile + 2 * halo
    if win % 32 or win > min(h, w):
        raise ValueError(f"windows of {win} px: the reference takes windows "
                         f"on the 32-px grid, inside a {h}x{w} frame")
    for iy in range(math.ceil(h / tile)):
        top = min(max(iy * tile - halo, 0), h - win)
        for ix in range(math.ceil(w / tile)):
            left = min(max(ix * tile - halo, 0), w - win)
            yield top, left, win, iy * tile, ix * tile


def reference_map(net: "ref.Net", raw: np.ndarray, seed: int, tile: int,
                  halo: int, device) -> torch.Tensor:
    """The (H, W) map of the frame: the reference's map of each window of
    the decoded frame with the sample noise the program draws for it
    (one standard-normal (1, win, win, 1) draw a window, in order, from
    one generator on the device seeded with ``seed``), its centre copied
    into place."""
    img = ref.decoded(raw, device)
    h, w = img.shape
    out = torch.empty_like(img)
    g = torch.Generator(device=device).manual_seed(int(seed))
    for top, left, win, cy, cx in windows(h, w, tile, halo):
        eps = torch.randn((1, win, win, 1), generator=g,
                          device=device)[0, :, :, 0]
        hm = ref.with_tf32_off(net.heatmap,
                               img[top:top + win, left:left + win], eps)
        sy, sx = min(tile, h - cy), min(tile, w - cx)
        oy, ox = cy - top, cx - left
        out[cy:cy + sy, cx:cx + sx] = hm[oy:oy + sy, ox:ox + sx]
    return out


def _maps(cell, prep, index: int, precision: str, device) -> torch.Tensor:
    mix = cell.traffic
    return reference_map(ref.Net(prep.weights, cell.config["model"],
                                 precision), prep.raws[index], prep.seed,
                         int(mix["tile"]), int(mix["halo"]), device)


def control(cell, prep, index: int, device):
    """The control's pick table: its stitched map in the precision below
    the configuration's, greedy NMS, the border filter."""
    config = cell.config
    hm = _maps(cell, prep, index, ref.precisions(config)[1], device)
    p = config["pick"]
    scores, rows, cols = ref.greedy_nms(hm, config["cfg"]["NMS"],
                                        p["threshold"])
    return ref.pick_table(scores, rows, cols, hm.shape, p["border"])


def judge(cell, prep, index: int, answer, device) -> Dict[str, float]:
    """`entries/pick.py`'s numbers, against the stitched float32 map and
    its twin rounded to the configuration's precision."""
    config = cell.config
    hm = _maps(cell, prep, index, "f32", device)
    hm_unit = _maps(cell, prep, index, ref.precisions(config)[0], device)
    r = int(config["cfg"]["NMS"])
    b = int(config["pick"]["border"])
    h, w = hm.shape
    dev = hm.device
    rows = torch.as_tensor(answer["x_coord"], dtype=torch.long, device=dev)
    cols = torch.as_tensor(answer["y_coord"], dtype=torch.long, device=dev)
    s = torch.as_tensor(answer["score"], dtype=torch.float32, device=dev)
    n = int(s.numel())
    inside = (rows > b) & (rows < h - b) & (cols > b) & (cols < w - b)
    out = {"border_out": float(n - int(inside.sum())),
           "order_breaks": float((s[1:] > s[:-1]).sum()) if n > 1 else 0.0}
    rows_c, cols_c = rows.clamp(0, h - 1), cols.clamp(0, w - 1)
    at, at_unit = hm[rows_c, cols_c], hm_unit[rows_c, cols_c]
    out["score_vs_bf16"] = (
        float((s - at).pow(2).mean().sqrt())
        / max(float((at_unit - at).pow(2).mean().sqrt()), TINY)
        if n else 0.0)
    if n > 1:
        d2 = ((rows[:, None] - rows[None]) ** 2
              + (cols[:, None] - cols[None]) ** 2)
        out["close_pairs"] = float(
            (torch.triu(d2 <= r * r, diagonal=1)).sum())
    else:
        out["close_pairs"] = 0.0
    out["uncovered_px"] = pick.uncovered_px(hm, hm_unit, rows_c, cols_c, s,
                                            config)
    return out
