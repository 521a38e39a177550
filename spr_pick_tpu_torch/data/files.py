"""Format-sniffing coordinate table reader, without pandas.

The PyTorch port of `spr_pick_tpu/data/files.py:read_coordinates` and the
readers it dispatches to (parity: `spr_pick/utils/files.py`): .star, .box
(EMAN), .csv (VIA) and .txt/.tab TSV.  Tables are `data/table.py` column
dicts.
"""

from __future__ import annotations

import csv
import json
import os

import numpy as np

from spr_pick_tpu_torch.data import star
from spr_pick_tpu_torch.data import table as tbl

PARTICLE_FORMAT_MAP = {
    ".star": "star",
    ".box": "box",
    ".json": "json",
    ".csv": "csv",
    ".txt": "coord",
    ".tab": "coord",
}


class UnknownFormatError(Exception):
    def __init__(self, ext):
        super().__init__(f"Unknown coordinate format: {ext}")
        self.ext = ext


def detect_format(path: str) -> str:
    _, ext = os.path.splitext(path)
    if ext not in PARTICLE_FORMAT_MAP:
        raise UnknownFormatError(ext)
    return PARTICLE_FORMAT_MAP[ext]


def strip_ext(name: str) -> str:
    return os.path.splitext(name)[0]


def read_box(path: str) -> np.ndarray:
    rows = []
    with open(path) as f:
        for line in f:
            if line.strip():
                rows.append([int(t) for t in line.split()[:4]])
    return np.array(rows, dtype=int).reshape(-1, 4)


def boxes_to_coordinates(boxes: np.ndarray, image_name: str) -> tbl.Table:
    """EMAN box rows (x_lo, y_lo, w, h) -> centre coordinates."""
    return {
        "image_name": np.array([image_name] * len(boxes), dtype=object),
        "x_coord": boxes[:, 0] + boxes[:, 2] // 2,
        "y_coord": boxes[:, 1] + boxes[:, 3] // 2,
    }


def read_via_csv(path: str) -> tbl.Table:
    """VIA-format CSV with region_shape_attributes dicts."""
    with open(path, newline="") as f:
        rows = [r for r in csv.DictReader(f) if int(r["region_count"]) > 0]
    table = {
        "image_name": np.array([strip_ext(r["filename"]) for r in rows],
                               dtype=object),
        "x_coord": np.array(
            [json.loads(r["region_shape_attributes"])["cx"] for r in rows],
            dtype=int),
        "y_coord": np.array(
            [json.loads(r["region_shape_attributes"])["cy"] for r in rows],
            dtype=int),
    }
    atts = [json.loads(r["region_attributes"]) for r in rows]
    if atts and "score" in atts[0]:
        table["score"] = np.array(
            [float(a["score"]) if "score" in a else -np.inf for a in atts],
            dtype=np.float32)
    return table


_STAR_RENAMES = {
    star.SCORE_COLUMN_NAME: "score",
    "MicrographName": "image_name",
    star.X_COLUMN_NAME: "x_coord",
    star.Y_COLUMN_NAME: "y_coord",
    star.VOLTAGE: "voltage",
    star.DETECTOR_PIXEL_SIZE: "detector_pixel_size",
    star.MAGNIFICATION: "magnification",
    star.AMPLITUDE_CONTRAST: "amplitude_contrast",
}


def read_coordinates(path: str, format: str = "auto") -> tbl.Table:
    if format == "auto":
        format = detect_format(path)
    if format == "star":
        with open(path) as f:
            table = star.parse(f)
        for k, v in _STAR_RENAMES.items():
            if k in table:
                table[v] = table.pop(k)
        table["image_name"] = np.array(
            [strip_ext(str(n)) for n in table["image_name"]], dtype=object)
        return table
    if format == "box":
        return boxes_to_coordinates(read_box(path),
                                    os.path.basename(strip_ext(path)))
    if format == "csv":
        return read_via_csv(path)
    return tbl.read_tsv(path)
