"""Image artifacts: min-max to 8 bit and an 8-bit grayscale PNG writer.

The PyTorch port of `spr_pick_tpu/utils/image_io.py:30-84` without PIL:
`to_u8` is `array2image`'s min-max to 8 bit, `quantize_u8_device` the same
math in torch on the tensor's device (same bytes: min and max are exact,
``hi - lo`` of two float32 values rounds once either way, and the float to
uint8 cast truncates toward zero in both), and `write_png` encodes with
`zlib` at the JAX package's default level 1 (filter 0 on every row).
`ScalarWriter` is the run dir's scalar log (`:96-123`).
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Optional

import numpy as np
import torch

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _png_compress_level() -> int:
    """zlib level for artifact PNGs: 1 by default (micrograph maps are
    noise-like and barely compress at any level); SPR_PNG_COMPRESS_LEVEL
    overrides (0-9)."""
    try:
        return int(os.environ.get("SPR_PNG_COMPRESS_LEVEL", "1"))
    except ValueError:
        return 1


def to_u8(img: np.ndarray) -> np.ndarray:
    """Min-max normalise to [0, 1] and truncate ``x * 255`` to uint8.

    Parity: array2image (image_io.py:30-47) for one grayscale image; accepts
    (H, W), (H, W, 1) or (1, H, W, 1).
    """
    x = np.squeeze(np.asarray(img, dtype=np.float32))
    if x.ndim != 2:
        raise NotImplementedError(f"cannot convert shape {np.shape(img)} to image")
    lo, hi = float(x.min()), float(x.max())
    x = (x - lo) / (hi - lo) if hi > lo else np.zeros_like(x)
    return np.uint8(x * 255)


def quantize_u8_device(arr: torch.Tensor, shape) -> torch.Tensor:
    """Unpad a (1, H', W', 1) map to ``shape`` and min-max quantise it to an
    (H, W) uint8 tensor on its device: the bytes of `to_u8` on the cropped
    map, with 1 byte/px to copy to the host instead of 4.  The crop comes
    BEFORE the min-max so pad pixels cannot skew the range."""
    x = arr[0, : shape[0], : shape[1], 0].float()
    lo, hi = x.min(), x.max()
    y = torch.where(hi > lo, (x - lo) / torch.clamp(hi - lo, min=1e-38),
                    torch.zeros_like(x))
    return (y * 255.0).to(torch.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(u8: np.ndarray, path: str) -> None:
    """Write an (H, W) uint8 array as an 8-bit grayscale PNG."""
    u8 = np.ascontiguousarray(u8, dtype=np.uint8)
    h, w = u8.shape
    rows = np.zeros((h, w + 1), np.uint8)  # filter byte 0 before each row
    rows[:, 1:] = u8
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    data = zlib.compress(rows.tobytes(), _png_compress_level())
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", data)
                + _chunk(b"IEND", b""))


def save_u8_image(u8, path: str) -> None:
    """Write an already-quantised (H, W) uint8 array or tensor as a PNG; a
    tensor on the GPU is copied to the host here."""
    if isinstance(u8, torch.Tensor):
        u8 = u8.cpu().numpy()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_png(u8, path)


def save_array_image(img: np.ndarray, path: str) -> None:
    save_u8_image(to_u8(img), path)


class ScalarWriter:
    """TensorBoard + JSONL scalar writer of a run dir, with purge-on-resume.

    Parity: `spr_pick_tpu/utils/image_io.py:96-123`: real tfevents records
    (`utils/tfevents.py`) and a `scalars.jsonl` sink beside them.
    """

    def __init__(self, log_dir: str, purge_step: Optional[int] = None):
        from spr_pick_tpu_torch.utils.tfevents import TFEventWriter

        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._tb = TFEventWriter(log_dir, purge_step=purge_step)
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")

    def add_scalar(self, tag: str, value, step: int):
        value = float(np.asarray(value))
        self._tb.add_scalar(tag, value, step)
        self._jsonl.write(
            json.dumps({"tag": tag, "value": value, "step": step}) + "\n"
        )
        self._jsonl.flush()

    def close(self):
        self._tb.close()
        self._jsonl.close()
