"""Column tables without pandas: what the port's commands read and write.

The JAX package reads manifests and coordinate files, and writes pick
tables, with pandas.  The port's command paths run where pandas is not
installed, so a table here is a plain ``{column: 1-D numpy array}`` dict in
column order, and the TSV text is read and written with the `csv` module.

Reading infers each column's type as ``pandas.read_csv`` does for the files
this package meets: all integers -> int64, all numbers -> float64, else
strings.  ``image_name`` and ``path`` always stay strings.  Writing prints
each value with ``str``: the shortest text that reads back to the same
float32 or float64 value, as pandas' ``to_csv`` writes them.
"""

from __future__ import annotations

import csv
from typing import Dict, Iterable, Sequence

import numpy as np

Table = Dict[str, np.ndarray]

PICK_COLUMNS = ("image_name", "x_coord", "y_coord", "score")
_TEXT_COLUMNS = ("image_name", "path")


def infer_column(values: Sequence[str]) -> np.ndarray:
    """Text cells -> int64, float64 or a string array."""
    for dtype in (np.int64, np.float64):
        try:
            return np.array([dtype(v) for v in values], dtype=dtype)
        except ValueError:
            continue
    return np.array(values, dtype=object)


def from_rows(header: Sequence[str], rows: Iterable[Sequence[str]],
              text_columns=_TEXT_COLUMNS) -> Table:
    """Rows of text cells -> a typed table."""
    cols = list(zip(*rows)) or [()] * len(header)
    return {
        name: (np.array(col, dtype=object) if name in text_columns
               else infer_column(col))
        for name, col in zip(header, cols)
    }


def read_tsv(path: str) -> Table:
    """A tab-separated file with a header row -> a typed table."""
    with open(path, newline="") as f:
        reader = csv.reader(f, delimiter="\t")
        header = next(reader)
        return from_rows(header, (r for r in reader if r))


def write_tsv(f, table: Table, header: bool = True) -> None:
    """Write ``table`` to the open text file ``f``, tab-separated."""
    writer = csv.writer(f, delimiter="\t", lineterminator="\n")
    if header:
        writer.writerow(list(table))
    for row in zip(*table.values()):
        writer.writerow([str(v) for v in row])


def num_rows(table: Table) -> int:
    return len(next(iter(table.values()))) if table else 0


def select(table: Table, keep: np.ndarray) -> Table:
    return {k: v[keep] for k, v in table.items()}


def concat(tables: Sequence[Table], columns=PICK_COLUMNS) -> Table:
    if not tables:
        return empty(columns)
    return {k: np.concatenate([t[k] for t in tables]) for k in tables[0]}


def empty(columns=PICK_COLUMNS) -> Table:
    return {k: np.array([], dtype=object) for k in columns}


def picks(name: str, scores: np.ndarray, coords: np.ndarray, shape,
          border: int) -> Table:
    """K1's picks of one micrograph of ``shape`` as a pick table, in NMS
    order: those more than ``border`` px inside every edge (all of them
    with ``border`` 0), with the reference's swapped columns, x_coord from
    coords[:, 1] and y_coord from coords[:, 0] (train.py:write_scores)."""
    keep = (
        (coords[:, 1] > border) & (coords[:, 1] < shape[0] - border)
        & (coords[:, 0] > border) & (coords[:, 0] < shape[1] - border)
    ) if border > 0 else np.ones(len(scores), bool)
    return {
        "image_name": np.array([name] * int(keep.sum()), dtype=object),
        "x_coord": coords[keep, 1].astype(np.int64),
        "y_coord": coords[keep, 0].astype(np.int64),
        "score": scores[keep],
    }


def to_frame(table: Table):
    """The table as a pandas DataFrame (pandas imported here only)."""
    import pandas as pd

    return pd.DataFrame(dict(table))
