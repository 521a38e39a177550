"""Format-sniffing coordinate table reader and writer, without pandas.

The PyTorch port of `spr_pick_tpu/data/files.py` (parity:
`spr_pick/utils/files.py:13-234`): `read_coordinates` reads .star, .box
(EMAN), .csv (VIA) and .txt/.tab TSV; `write_coordinates` writes TSV, star,
one .box or EMAN2 `_info.json` an image, or VIA csv, with the bytes the
pandas version writes.  Tables are `data/table.py` column dicts.
"""

from __future__ import annotations

import csv
import json
import os
from collections import Counter

import numpy as np

from spr_pick_tpu_torch.data import star
from spr_pick_tpu_torch.data import table as tbl
from spr_pick_tpu_torch.data.conversions import (
    boxes_to_coordinates,
    coordinates_to_boxes,
    coordinates_to_eman2_json,
    coordinates_to_star,
)

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
        return boxes_to_coordinates(
            read_box(path), image_name=os.path.basename(strip_ext(path)))
    if format == "csv":
        return read_via_csv(path)
    return tbl.read_tsv(path)


def write_via_csv(path: str, table: tbl.Table) -> None:
    """VIA csv: one row a point, its image's point count and its index
    among them, the point and its score as JSON cells."""
    names = [str(n) for n in table["image_name"]]
    counts = Counter(names)
    seen = Counter()
    region_id = []
    for n in names:
        region_id.append(seen[n])
        seen[n] += 1
    x, y = table["x_coord"], table["y_coord"]
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(["filename", "file_size", "file_attributes",
                         "region_count", "region_id",
                         "region_shape_attributes", "region_attributes"])
        for i, n in enumerate(names):
            shape = '{{"name":"point","cx":{},"cy":{}}}'.format(x[i], y[i])
            att = ('{{"score":"{}"}}'.format(table["score"][i])
                   if "score" in table else "{}")
            writer.writerow([n + ".png", -1, "{}", counts[n], region_id[i],
                             shape, att])


def write_coordinates(path: str, table: tbl.Table, format: str = "auto",
                      boxsize: int = 0, image_ext: str = ".mrc",
                      suffix: str = "") -> None:
    """Write ``table`` (image_name, x_coord, y_coord[, score]) as
    ``format``: "box" and "json" write one file an image into the
    directory ``path`` (``{image}{suffix}.box`` with ``boxsize`` boxes,
    ``{image}{suffix}_info.json``), in sorted image order; "star" (names
    get ``image_ext``), "csv" (VIA) and anything else (TSV) write ``path``.
    """
    if format in ("box", "json"):
        names = np.asarray([str(n) for n in table["image_name"]])
        xy = np.stack([np.asarray(table["x_coord"]),
                       np.asarray(table["y_coord"])], axis=1)
        for image_name in sorted(set(names)):
            group = xy[names == image_name]
            if format == "box":
                this_path = os.path.join(path, image_name + suffix + ".box")
                boxes = coordinates_to_boxes(group.astype(np.int32), boxsize,
                                             boxsize)
                with open(this_path, "w") as f:
                    for row in boxes:
                        f.write("\t".join(str(v) for v in row) + "\n")
            else:
                this_path = os.path.join(path,
                                         image_name + suffix + "_info.json")
                with open(this_path, "w") as f:
                    json.dump({"boxes": coordinates_to_eman2_json(
                        group.astype(int))}, f, indent=0)
    elif format == "star":
        with open(path, "w") as f:
            star.write(coordinates_to_star(table, image_ext=image_ext), f)
    elif format == "csv":
        write_via_csv(path, table)
    else:
        columns = ["image_name", "x_coord", "y_coord"]
        if "score" in table:
            columns.append("score")
        with open(path, "w") as f:
            tbl.write_tsv(f, {k: table[k] for k in columns})
