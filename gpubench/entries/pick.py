"""Entry ``pick``: `Picker.pick_many_table([path])`, one micrograph a
request (MRC decode, dense forward, sample, detector, K1, the border
filter and the table), judged against the plain reference's map.

An entry module gives what `gpubench/bench.py` and `gpubench/readings.py`
call, found by a traffic mix's ``entry``: ``prepare`` (set-up: the
program, the items a request sends, what the judge needs), ``call``,
``size``, ``end_to_end`` (the window's readings), ``judge`` (the numbers
of one answer against the reference), ``control`` (the control's answer,
for `readings.py`) and ``EXACT`` (the numbers compared with limit 0).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from gpubench import program
from gpubench.reference import model as ref
from gpubench.requests import mic_metrics

TINY = 1e-12   # a unit below this means the reference map did not move
# A pixel counts as uncovered past this many widest gaps of the rounded
# map.  The sound program's widest excess read 0.24-2.53 such units over
# 12 seeds and 0.27-1.69 over 12 more answers on the H100; the float8
# control's 4.78-13.78 and a dropped best pick's 3.77-13.70 (PERF.md).
UNCOVERED_UNITS = 10.0
# Numbers compared exactly (limit 0): properties every correct pick table
# has, whatever the rounding of the map.
EXACT = ("close_pairs", "border_out", "order_breaks", "uncovered_px")

prepare = program.prepare_picker


def call(picker, path: str):
    table = picker.pick_many_table([path])
    return {k: np.asarray(table[k]) for k in ("x_coord", "y_coord", "score")}


def size(answer) -> int:
    return int(len(answer["score"]))


def end_to_end(latencies, sizes, window_s: float, err) -> Dict[str, float]:
    return mic_metrics(latencies, sizes, window_s, err)


def reference_map(net: "ref.Net", raw: np.ndarray, seed: int, device):
    img = ref.decoded(raw, device)
    eps = program.sample_noise(img.shape, seed, device)
    return ref.with_tf32_off(net.heatmap, img, eps)


def control(cell, prep, index: int, device):
    """The control's pick table: its own map in the precision below the
    configuration's, greedy NMS, the border filter."""
    model, config = cell.config["model"], cell.config
    low = ref.Net(prep.weights, model, ref.precisions(config)[1])
    hm = reference_map(low, prep.raws[index], prep.seed, device)
    p = config["pick"]
    scores, rows, cols = ref.greedy_nms(hm, config["cfg"]["NMS"],
                                        p["threshold"])
    return ref.pick_table(scores, rows, cols, hm.shape, p["border"])


def judge(cell, prep, index: int, answer, device) -> Dict[str, float]:
    """Numbers of a pick table against the float32 reference map, the gaps
    in units of what rounding the reference to the configuration's
    precision moves its map at the same pixels:

    - ``score_vs_bf16``: the RMS over the picks of a pick's score less
      the reference map at its (x_coord = row, y_coord = column), over
      the RMS of the rounded map less the reference there;
    - ``uncovered_px``: greedy NMS leaves every pixel above the
      threshold within the radius of a pick scoring at least as much, so
      a pixel's reference score can exceed the best pick within reach
      (the threshold where none is) by no more than the program's own
      map's gap to the reference there; the pixels, far enough inside
      the border that every pick in reach survives its filter, whose
      excess passes `UNCOVERED_UNITS` times the widest gap of the
      rounded map there (a pick left out leaves its whole score less
      what covers it);
    - ``close_pairs``: pairs of picks within the radius (greedy NMS
      leaves none);
    - ``border_out``: picks not strictly inside the border frame;
    - ``order_breaks``: places where a score rises down the table.
    """
    config, model = cell.config, cell.config["model"]
    raw = prep.raws[index]
    hm = reference_map(ref.Net(prep.weights, model, "f32"), raw, prep.seed,
                       device)
    hm_unit = reference_map(
        ref.Net(prep.weights, model, ref.precisions(config)[0]), raw,
        prep.seed, device)
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
    out["uncovered_px"] = uncovered_px(hm, hm_unit, rows_c, cols_c, s, config)
    return out


def uncovered_px(hm, hm_unit, rows, cols, scores, config) -> float:
    """``uncovered_px`` of `judge`, for a pick table (``rows``, ``cols``,
    ``scores``) against the reference map ``hm`` and its rounded twin."""
    r = int(config["cfg"]["NMS"])
    b = int(config["pick"]["border"])
    h, w = hm.shape
    cover = torch.full((h * w,), float(config["pick"]["threshold"]),
                       device=hm.device)
    if scores.numel():
        dy, dx = ref.disk_offsets(r, hm.device)
        yy, xx = rows[:, None] + dy, cols[:, None] + dx
        ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        cover.scatter_reduce_(0, (yy * w + xx)[ok],
                              scores[:, None].expand_as(yy)[ok], "amax")
    m = b + r + 1
    inner = (slice(m, h - m), slice(m, w - m))
    excess = (hm - cover.view(h, w))[inner]
    unit = max(float((hm_unit - hm)[inner].abs().max()), TINY)
    return float((excess > UNCOVERED_UNITS * unit).sum())
