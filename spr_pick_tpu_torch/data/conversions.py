"""Coordinate-format conversions (EMAN boxes, EMAN2 json, star columns),
without pandas.

The PyTorch port of `spr_pick_tpu/data/conversions.py` (parity:
`spr_pick/utils/conversions.py:8-91`).  Tables are `data/table.py` column
dicts; coordinate arrays are (N, 2) numpy arrays of (x, y).
"""

from __future__ import annotations

import numpy as np

from spr_pick_tpu_torch.data import star
from spr_pick_tpu_torch.data import table as tbl


def boxes_to_coordinates(boxes, shape=None, invert_y=False, image_name=None):
    """EMAN box rows (x_lo, y_lo, w, h) -> centre coordinates: an (N, 2)
    array, or with ``image_name`` a table (image_name, x_coord, y_coord).
    No boxes give an empty table (x_coord, y_coord[, image_name])."""
    if len(boxes) < 1:
        columns = ["x_coord", "y_coord"]
        if image_name is not None:
            columns.append("image_name")
        return tbl.empty(columns)

    x_lo, y_lo, width, height = (boxes[:, i] for i in range(4))
    x_coord = x_lo + width // 2
    y_coord = y_lo + height // 2
    if invert_y:
        y_coord = (shape[0] - 1 - y_lo) - height // 2

    coords = np.stack([x_coord, y_coord], axis=1)
    if image_name is not None:
        coords = {
            "image_name": np.array([image_name] * len(coords), dtype=object),
            "x_coord": coords[:, 0],
            "y_coord": coords[:, 1],
        }
    return coords


def coordinates_to_boxes(coords, box_width, box_height, shape=None,
                         invert_y=False):
    x = np.asarray(coords[:, 0])
    y = np.asarray(coords[:, 1])
    if invert_y:
        y = shape[0] - 1 - y
    w = np.full(len(x), box_width, dtype=np.int32)
    h = np.full(len(x), box_height, dtype=np.int32)
    return np.stack([x - w // 2, y - h // 2, w, h], axis=1)


def coordinates_to_eman2_json(coords, shape=None, invert_y=False,
                              tag="manual"):
    x = np.asarray(coords[:, 0])
    y = np.asarray(coords[:, 1])
    if invert_y:
        y = shape[0] - 1 - y
    return [[int(xi), int(yi), tag] for xi, yi in zip(x, y)]


_STAR_RENAMES = {
    "score": star.SCORE_COLUMN_NAME,
    "image_name": "MicrographName",
    "x_coord": star.X_COLUMN_NAME,
    "y_coord": star.Y_COLUMN_NAME,
    "voltage": star.VOLTAGE,
    "detector_pixel_size": star.DETECTOR_PIXEL_SIZE,
    "magnification": star.MAGNIFICATION,
    "amplitude_contrast": star.AMPLITUDE_CONTRAST,
}


def coordinates_to_star(table: tbl.Table, image_ext: str = "") -> tbl.Table:
    """Rename to star columns (each renamed column moves to the end, as in
    the pandas version) and append ``image_ext`` to the micrograph names."""
    table = dict(table)
    for k, v in _STAR_RENAMES.items():
        if k in table:
            table[v] = table.pop(k)
    table["MicrographName"] = np.array(
        [x + image_ext for x in table["MicrographName"]], dtype=object)
    return table
