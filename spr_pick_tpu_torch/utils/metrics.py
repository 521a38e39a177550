"""Running-mean metrics, time tracking, PSNR and console formatting.

The PyTorch port's copy of `spr_pick_tpu/utils/metrics.py` (Metric,
MetricDict, TrackedTime, seconds_to_dhms, separator, mse2psnr,
calculate_psnr), over numpy arrays.
"""

from __future__ import annotations

import time
from collections import OrderedDict

import numpy as np


class Metric:
    """Accumulates a batched running mean.  Batch must be the first dim."""

    def __init__(self, batched: bool = True, collapse: bool = True):
        self.batched = batched
        self.collapse = collapse
        self.reset()

    def add(self, value):
        value = np.asarray(value, dtype=np.float64)
        n = value.shape[0] if (self.batched and value.ndim > 0) else 1
        if self.collapse:
            data_start = 1 if (self.batched and value.ndim > 0) else 0
            mean_dims = tuple(range(data_start, value.ndim))
            if mean_dims:
                value = np.mean(value, axis=mean_dims)
        if self.batched and value.ndim > 0:
            value = np.sum(value, axis=0)
        self.total = value if self.total is None else self.total + value
        self.n += n

    def __add__(self, value):
        self.add(value)
        return self

    def accumulated(self):
        return None if self.n == 0 else self.total / self.n

    def reset(self):
        self.total = None
        self.n = 0

    def empty(self) -> bool:
        return self.n == 0


class MetricDict(OrderedDict):
    def __missing__(self, key):
        self[key] = value = Metric()
        return value


class TrackedTime:
    """Accumulates wall-clock time between `update()` calls."""

    def __init__(self):
        self.total = 0
        self.last_time = None

    def update(self):
        current_time = time.time()
        if self.last_time is not None:
            self.total += current_time - self.last_time
        self.last_time = current_time

    def forget(self):
        self.last_time = None


def seconds_to_dhms(seconds: float, trim: bool = True) -> str:
    s = seconds % 60
    m = (seconds // 60) % 60
    h = seconds // (60 * 60) % 24
    d = seconds // (60 * 60 * 24)
    time_str = ""
    for t, char in ((d, "d"), (h, "h"), (m, "m"), (s, "s")):
        if trim and t < 1:
            continue
        trim = False
        time_str += "{:02}{}".format(int(t), char)
    return time_str


def separator(cols: int = 100) -> str:
    return "#" * cols


def mse2psnr(mse, float_imgs: bool = True):
    """PSNR from MSE.  Parity: spr_pick/utils/data.py:124-126."""
    high_val = 1.0 if float_imgs else 255.0
    return 20 * np.log10(high_val) - 10 * np.log10(mse)


def calculate_psnr(img, ref):
    """Per-item PSNR over trailing (non-batch) dims for float images.

    Parity: spr_pick/utils/data.py:129-135.
    """
    img = np.asarray(img, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    axes = tuple(range(1, img.ndim))
    mse = np.mean((img - ref) ** 2, axis=axes)
    return mse2psnr(mse, True)
