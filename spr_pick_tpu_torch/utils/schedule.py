"""Learning-rate schedule.

The PyTorch port's copy of `spr_pick_tpu/utils/schedule.py:11-37`
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
