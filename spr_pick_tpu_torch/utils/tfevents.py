"""Minimal pure-Python TensorBoard event-file writer.

The PyTorch port's copy of `spr_pick_tpu/utils/tfevents.py`.  The reference
writes TensorBoard event files via `torch.utils.tensorboard.SummaryWriter`
(reference train.py:819-835), which needs the tensorboard package; a
tfevents file is a TFRecord stream of serialized `tensorflow.Event` protos,
and for scalar summaries the wire encoding is small enough to emit by hand.

Wire formats implemented here:

* TFRecord framing: ``uint64 length | uint32 masked_crc32c(length) |
  data | uint32 masked_crc32c(data)`` (little-endian, CRC32-Castagnoli
  with TensorFlow's rotate+offset masking).
* ``Event`` proto fields: wall_time (1, double), step (2, int64),
  file_version (3, string), summary (5, message), session_log (7,
  message).  ``Summary.Value``: tag (1, string), simple_value (2, float).
* Purge-on-resume: a ``SessionLog{status: START}`` event at
  ``purge_step`` makes TensorBoard discard previously-written events with
  ``step >= purge_step`` — the same mechanism SummaryWriter's
  ``purge_step`` argument uses.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time
from typing import Optional

# ---------------------------------------------------------------------------
# CRC32-Castagnoli (reflected polynomial 0x82F63B78) + TensorFlow masking
# ---------------------------------------------------------------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 * (_c & 1))
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Hand-rolled protobuf encoding (only the fields scalar events need)
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _field_double(field: int, value: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", value)


def _field_float(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", value)


def _field_varint(field: int, value: int) -> bytes:
    if value < 0:
        value += 1 << 64  # int64 two's-complement as uint64 varint
    return _tag(field, 0) + _varint(value)


def _field_bytes(field: int, value: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(value)) + value


def _scalar_summary(tag: str, value: float) -> bytes:
    val = _field_bytes(1, tag.encode("utf-8")) + _field_float(2, value)
    return _field_bytes(1, val)  # Summary.value (repeated field 1)


def _event(wall_time: float, step: int, body: bytes) -> bytes:
    return _field_double(1, wall_time) + _field_varint(2, step) + body


class TFEventWriter:
    """Append scalar events to an ``events.out.tfevents.*`` file."""

    def __init__(self, log_dir: str, purge_step: Optional[int] = None):
        os.makedirs(log_dir, exist_ok=True)
        fname = "events.out.tfevents.{:.0f}.{}.{}".format(
            time.time(), socket.gethostname(), os.getpid()
        )
        self._path = os.path.join(log_dir, fname)
        self._file = open(self._path, "ab")
        self._lock = threading.Lock()
        now = time.time()
        self._write_record(
            _event(now, 0, _field_bytes(3, b"brain.Event:2"))
        )
        if purge_step is not None:
            # SessionLog { status: START }  (Event field 7; status field 1)
            session_log = _field_varint(1, 1)
            self._write_record(
                _event(now, int(purge_step), _field_bytes(7, session_log))
            )
        self.flush()

    @property
    def path(self) -> str:
        return self._path

    def _write_record(self, data: bytes):
        header = struct.pack("<Q", len(data))
        with self._lock:
            self._file.write(header)
            self._file.write(struct.pack("<I", _masked_crc(header)))
            self._file.write(data)
            self._file.write(struct.pack("<I", _masked_crc(data)))

    def add_scalar(self, tag: str, value: float, step: int):
        self._write_record(
            _event(time.time(), int(step), _field_bytes(5, _scalar_summary(tag, float(value))))
        )

    def flush(self):
        with self._lock:
            self._file.flush()

    def close(self):
        self.flush()
        self._file.close()
