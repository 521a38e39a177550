"""Learning-rate schedule.

The PyTorch port's copy of `spr_pick_tpu/utils/schedule.py`
(parity: `spr_pick/utils/utils.py:50-69`).
"""

from __future__ import annotations

import numpy as np


def compute_ramped_lrate(
    i: int,
    iteration_count: int,
    ramp_up_fraction: float,
    ramp_down_fraction: float,
    learning_rate: float,
) -> float:
    """Cosine ramp-up / ramp-down schedule (Laine et al.).

    The trainer calls this with (rampdown, rampup) swapped relative to the
    signature, as the reference does (train.py:433-441); the swap lives at
    the call site (`train.py:DenoiserTrainer.learning_rate`), and this
    signature stays the reference's.
    """
    if ramp_up_fraction > 0.0:
        ramp_up_end_iter = iteration_count * ramp_up_fraction
        if i <= ramp_up_end_iter:
            t = (i / ramp_up_fraction) / iteration_count
            learning_rate = learning_rate * (0.5 - np.cos(t * np.pi) / 2)

    if ramp_down_fraction > 0.0:
        ramp_down_start_iter = iteration_count * (1 - ramp_down_fraction)
        if i >= ramp_down_start_iter:
            t = ((i - ramp_down_start_iter) / ramp_down_fraction) / iteration_count
            learning_rate = learning_rate * (0.5 + np.cos(t * np.pi) / 2) ** 2

    return learning_rate


def insize_from_outsize(layers, outsize: int) -> int:
    """Input size of a conv stack producing `outsize` outputs.

    `layers` is a sequence of objects (or dicts) carrying kernel_size /
    stride / padding / dilation.  The port's copy of
    `spr_pick_tpu/utils/schedule.py:40-61` (parity:
    `spr_pick/utils/utils.py:18-47`).
    """

    def _get(layer, name, default):
        if isinstance(layer, dict):
            v = layer.get(name, default)
        else:
            v = getattr(layer, name, default)
        if isinstance(v, tuple):
            v = v[0]
        return v

    for layer in layers[::-1]:
        kernel_size = _get(layer, "kernel_size", 1)
        stride = _get(layer, "stride", 1)
        pad = _get(layer, "padding", 0)
        dilation = _get(layer, "dilation", 1)
        outsize = (outsize - 1) * stride + 1 + (kernel_size - 1) * dilation - 2 * pad
    return outsize
