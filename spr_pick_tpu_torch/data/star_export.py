"""Aggregate picks into a RELION .star file, without pandas.

The PyTorch port of `spr_pick_tpu/data/star_export.py`: score threshold
(0.13), coordinate upscale (x4) and an optional post-scale border filter,
from the evaluator's `*_scores.txt` files (`convert`, the eval
`--export_star` flag) or from an in-memory picks table (`frame_to_star`,
the `pick` command's `.star` output).
"""

from __future__ import annotations

import glob
import os

import numpy as np

from spr_pick_tpu_torch.data import star
from spr_pick_tpu_torch.data import table as tbl


def convert(scores_dir: str, output: str, threshold: float = 0.13,
            scale: float = 4.0, borders=None) -> int:
    """Write all `scores_dir/*_scores.txt` picks above `threshold` to a
    .star at `output`; returns the number of particles written.

    `borders`: optional (xmin, xmax, ymin, ymax) keep-window applied AFTER
    scaling.
    """
    tables = [tbl.read_tsv(p) for p in
              sorted(glob.glob(os.path.join(scores_dir, "*_scores.txt")))]
    if not tables:
        raise FileNotFoundError(f"no *_scores.txt files found in {scores_dir}")
    return frame_to_star(tbl.concat(tables), output, threshold=threshold,
                         scale=scale, borders=borders)


def frame_to_star(table: tbl.Table, output: str, threshold: float = 0.13,
                  scale: float = 4.0, borders=None) -> int:
    """The same star conversion from a picks table
    (image_name/x_coord/y_coord/score, the `_scores.txt` schema)."""
    table = tbl.select(table, np.asarray(table["score"] > threshold, bool))
    x = (table["x_coord"] * scale).astype(np.int64)
    y = (table["y_coord"] * scale).astype(np.int64)
    keep = np.ones(len(x), bool)
    if borders is not None:
        xmin, xmax, ymin, ymax = borders
        keep = (x > xmin) & (x < xmax) & (y > ymin) & (y < ymax)
    out = {
        "MicrographName": table["image_name"][keep],
        star.X_COLUMN_NAME: x[keep],
        star.Y_COLUMN_NAME: y[keep],
        star.SCORE_COLUMN_NAME: table["score"][keep],
    }
    with open(output, "w") as f:
        star.write(out, f)
    return int(keep.sum())
