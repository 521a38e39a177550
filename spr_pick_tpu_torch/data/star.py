"""RELION STAR file parsing and writing, without pandas.

The PyTorch port of `spr_pick_tpu/data/star.py` (parity:
`spr_pick/utils/star.py:15-97`): loop-block parser with the `rln` prefix
strip, typed columns, `ParticleScore` -> `AutopickFigureOfMerit` upgrade,
and the `_rln<name> #i` write format.  Tables are `data/table.py` column
dicts.
"""

from __future__ import annotations

import numpy as np

from spr_pick_tpu_torch.data import table as tbl

X_COLUMN_NAME = "CoordinateX"
Y_COLUMN_NAME = "CoordinateY"
SCORE_COLUMN_NAME = "AutopickFigureOfMerit"
OLD_SCORE_COLUMN_NAME = "ParticleScore"

VOLTAGE = "Voltage"
DETECTOR_PIXEL_SIZE = "DetectorPixelSize"
MAGNIFICATION = "Magnification"
AMPLITUDE_CONTRAST = "AmplitudeContrast"

_FLOAT_COLS = (VOLTAGE, DETECTOR_PIXEL_SIZE, MAGNIFICATION, AMPLITUDE_CONTRAST)


def parse(f) -> tbl.Table:
    """Parse the first data_ block of a STAR file into a table."""
    lines = f.readlines()
    for i, line in enumerate(lines):
        if line.startswith("data_"):
            return _parse_body(lines[i + 1 :])
    return {}


def _parse_body(lines) -> tbl.Table:
    for i, line in enumerate(lines):
        if line.startswith("loop_"):
            lines = lines[i + 1 :]
            break

    header, lines = _parse_loop_header(lines)
    content = []
    for line in lines:
        line = line.strip()
        if line.startswith("data"):
            break
        if line.startswith("#") or line.startswith(";"):
            continue
        if line:
            content.append(line.split())
    # Cells stay text, like pandas over split lines, until typed below.
    table = tbl.from_rows(header, content, text_columns=header)

    if OLD_SCORE_COLUMN_NAME in table and SCORE_COLUMN_NAME not in table:
        table[SCORE_COLUMN_NAME] = table.pop(OLD_SCORE_COLUMN_NAME)
    for col in (X_COLUMN_NAME, Y_COLUMN_NAME):
        if col in table:
            table[col] = table[col].astype(float).astype(np.int64)
    for col in (SCORE_COLUMN_NAME,) + _FLOAT_COLS:
        if col in table:
            table[col] = table[col].astype(float)
    return table


def _parse_loop_header(lines):
    columns = []
    i = 0
    for i, line in enumerate(lines):
        line = line.strip()
        if not line.startswith("_"):
            break
        name = line[1:]
        loc = name.find("#")
        if loc >= 0:
            name = name[:loc]
        if name.startswith("rln"):
            name = name[3:]
        columns.append(name.strip())
    return columns, lines[i:]


def write(table: tbl.Table, f) -> None:
    """Write a `data_images` / `loop_` block with _rln-prefixed columns."""
    print("data_images", file=f)
    print("loop_", file=f)
    for i, name in enumerate(table):
        print("_rln" + name + " #" + str(i + 1), file=f)
    tbl.write_tsv(f, table, header=False)
