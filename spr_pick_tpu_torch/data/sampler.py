"""The evaluation sampler.

The PyTorch port of `spr_pick_tpu/data/sampler.py:268-320`
(`FixedLengthSampler`, parity: `spr_pick/datasets/sampler.py:157-235`)
without its resume hooks, which only training uses.  The training samplers
belong to a later slice.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np


class FixedLengthSampler:
    """Sequential-or-shuffled sampler of exactly N indices with wraparound."""

    def __init__(self, data_len: int, num_samples: Optional[int] = None,
                 shuffled: bool = False, random=np.random):
        self.data_len = data_len
        self._num_samples = num_samples
        self.shuffled = shuffled
        self.random = random

    @property
    def num_samples(self) -> int:
        return (self._num_samples if self._num_samples is not None
                else self.data_len)

    def _sample(self) -> Iterator[int]:
        remaining = self.num_samples
        if self.shuffled:
            while remaining > 0:
                n = min(remaining, self.data_len)
                for idx in self.random.permutation(self.data_len)[:n]:
                    yield int(idx)
                remaining -= n
        else:
            current = 0
            while remaining > 0:
                if current >= self.data_len:
                    current = 0
                yield current
                current += 1
                remaining -= 1

    def __iter__(self) -> Iterator[int]:
        return iter(list(self._sample()))

    def __len__(self) -> int:
        return self.num_samples
