"""MRC2000 image I/O.

Parity: `spr_pick/utils/mrc.py:105-225` (hand-rolled header parse/write,
modes 0/1/2/3/4/6/16).  Implemented with a numpy structured dtype over the
1024-byte header instead of `struct` — same on-disk layout; `parse` views
the bytes it is given, `read` reads the payload once into its array.

The PyTorch port's copy of `spr_pick_tpu/data/mrc.py` (read, parse,
`make_header`, write).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

# MRC2000 / IMOD header layout (1024 bytes).
HEADER_DTYPE = np.dtype(
    [
        ("nx", "<i4"), ("ny", "<i4"), ("nz", "<i4"),
        ("mode", "<i4"),
        ("nxstart", "<i4"), ("nystart", "<i4"), ("nzstart", "<i4"),
        ("mx", "<i4"), ("my", "<i4"), ("mz", "<i4"),
        ("xlen", "<f4"), ("ylen", "<f4"), ("zlen", "<f4"),
        ("alpha", "<f4"), ("beta", "<f4"), ("gamma", "<f4"),
        ("mapc", "<i4"), ("mapr", "<i4"), ("maps", "<i4"),
        ("amin", "<f4"), ("amax", "<f4"), ("amean", "<f4"),
        ("ispg", "<i4"), ("next", "<i4"), ("creatid", "<i2"),
        ("extra1", "V30"),
        ("nint", "<i2"), ("nreal", "<i2"),
        ("extra2", "V20"),
        ("imodStamp", "<i4"), ("imodFlags", "<i4"),
        ("idtype", "<i2"), ("lens", "<i2"),
        ("nd1", "<i2"), ("nd2", "<i2"), ("vd1", "<i2"), ("vd2", "<i2"),
        ("tiltangles", "<f4", (6,)),
        ("xorg", "<f4"), ("yorg", "<f4"), ("zorg", "<f4"),
        ("cmap", "S4"), ("stamp", "S4"),
        ("rms", "<f4"),
        ("nlabl", "<i4"),
        ("labels", "S800"),
    ]
)
assert HEADER_DTYPE.itemsize == 1024

MODE_TO_DTYPE = {
    0: np.dtype(np.int8),
    1: np.dtype(np.int16),
    2: np.dtype(np.float32),
    3: np.dtype("2h"),
    4: np.dtype(np.complex64),
    6: np.dtype(np.uint16),
    16: np.dtype("3B"),
}


def _layout(head: bytes):
    """The header record of an MRC file's first 1024 bytes, and its
    payload's dtype, (nz, ny, nx) shape and byte offset."""
    header = np.frombuffer(head, dtype=HEADER_DTYPE, count=1)[0]
    mode = int(header["mode"])
    if mode not in MODE_TO_DTYPE:
        raise ValueError(f"Unknown MRC dtype mode: {mode}")
    shape = (int(header["nz"]), int(header["ny"]), int(header["nx"]))
    return header, MODE_TO_DTYPE[mode], shape, 1024 + int(header["next"])


def _sections(array: np.ndarray, shape) -> np.ndarray:
    array = array.reshape(shape)
    return array[0] if shape[0] == 1 else array


def parse(content: bytes) -> Tuple[np.ndarray, np.void, bytes]:
    """Parse MRC bytes -> (array, header record, extended header bytes).
    The array is a read-only view of ``content``."""
    header, dtype, shape, start = _layout(content)
    array = np.frombuffer(content, dtype=dtype, count=int(np.prod(shape)),
                          offset=start)
    return _sections(array, shape), header, content[1024:start]


def read(path) -> Tuple[np.ndarray, np.void, bytes]:
    """`parse` of the file at ``path`` (or of an open binary file, from
    its position); the payload is read once, straight into a writable
    array."""
    if isinstance(path, (str, os.PathLike)):
        with open(path, "rb") as f:
            return read(f)
    header, dtype, shape, start = _layout(path.read(1024))
    extended_header = path.read(start - 1024)
    array = np.fromfile(path, dtype=dtype, count=int(np.prod(shape)))
    return _sections(array, shape), header, extended_header


def dtype_to_mode(dtype) -> int:
    for mode, d in MODE_TO_DTYPE.items():
        if np.dtype(dtype) == d:
            return mode
    raise ValueError(f"MRC incompatible dtype: {dtype}")


def make_header(
    shape,
    cella=(1.0, 1.0, 1.0),
    cellb=(0.0, 0.0, 0.0),
    mz: int = 1,
    dtype=np.float32,
    dmin: float = 0,
    dmax: float = -1,
    dmean: float = -2,
    rms: float = -1,
    exthd_size: int = 0,
    ispg: int = 0,
) -> np.void:
    """The header record of a (nz, ny, nx) map of ``dtype``."""
    header = np.zeros((), dtype=HEADER_DTYPE)
    header["nx"], header["ny"], header["nz"] = shape[2], shape[1], shape[0]
    header["mode"] = dtype_to_mode(dtype)
    header["mx"], header["my"], header["mz"] = 1, 1, mz
    header["xlen"], header["ylen"], header["zlen"] = cella
    header["alpha"], header["beta"], header["gamma"] = cellb
    header["mapc"], header["mapr"], header["maps"] = 1, 2, 3
    header["amin"], header["amax"], header["amean"] = dmin, dmax, dmean
    header["ispg"] = ispg
    header["next"] = exthd_size
    header["rms"] = rms
    return header[()]


def write(f, array: np.ndarray, header=None, extended_header: bytes = b"",
          ax: float = 1, ay: float = 1, az: float = 1):
    """Write a float32 MRC file.  Parity: mrc.py:192-224."""
    array3 = array.astype(np.float32)
    if array3.ndim == 2:
        array3 = array3[None]
    if header is None:
        header = make_header(
            array3.shape, cella=(ax, ay, az), dmin=array3.min(),
            dmax=array3.max(), dmean=array3.mean(), rms=array3.std(),
            exthd_size=len(extended_header),
        )

    close = False
    if isinstance(f, str):
        f = open(f, "wb")
        close = True
    try:
        f.write(np.asarray(header, dtype=HEADER_DTYPE).tobytes())
        f.write(extended_header)
        f.write(array3.tobytes())
    finally:
        if close:
            f.close()
