"""Stratified positive-unlabeled coordinate sampling, and the evaluation
sampler.

The PyTorch port's copy of `spr_pick_tpu/data/sampler.py:26-265`
(`pack_index`/`unpack_index`, `enumerate_pu_coordinates`,
`ShuffledSampler`, `StratifiedCoordinateSampler`; parity:
`spr_pick/datasets/sampler.py:14-155`) and of `FixedLengthSampler`
(:268-320) without its resume hooks, which the trainer does not use.
Everything is numpy, so with equal seeds the port draws the JAX package's
packed indices exactly.  The JAX package's differences from the reference
hold here too: the border test compares rows with the height and columns
with the width (the reference swaps them, sampler.py:31-35), the margins
(72 top/left, 140 bottom/right) are parameters, empty strata are never
drawn, and the sampler's state is resumable.

The packed-index ABI is ``g*2**56 + i*2**32 + coord`` (sampler.py:143-146).
"""

from __future__ import annotations

import logging
from typing import Iterator, List, Optional, Sequence

import numpy as np


PACK_GROUP = 2 ** 56
PACK_IMAGE = 2 ** 32


def pack_index(g: int, i: int, coord: int) -> int:
    return int(g) * PACK_GROUP + int(i) * PACK_IMAGE + int(coord)


def unpack_index(h):
    """Decode packed index -> (group, image, coord).  Vectorised."""
    h = np.asarray(h, dtype=np.int64)
    g = h // PACK_GROUP
    h = h - g * PACK_GROUP
    i = h // PACK_IMAGE
    coord = h - i * PACK_IMAGE
    return g, i, coord


def enumerate_pu_coordinates(
    labels: Sequence[np.ndarray],
    margin_lo: int = 72,
    margin_hi: int = 140,
):
    """Positive and unlabeled (image, coord) pairs within the border margins.

    Returns structured arrays P, U with fields (image, coord) — same layout
    the reference builds (sampler.py:22-23), computed with numpy masks.
    """
    p_rows: List[np.ndarray] = []
    u_rows: List[np.ndarray] = []
    for image_idx, y in enumerate(labels):
        r, c = y.shape
        rows = np.arange(r)
        cols = np.arange(c)
        row_ok = (rows > margin_lo) & (rows < r - margin_hi)
        col_ok = (cols > margin_lo) & (cols < c - margin_hi)
        valid = row_ok[:, None] & col_ok[None, :]

        coords = np.flatnonzero(valid).astype(np.uint32)
        u = np.empty(len(coords), dtype=[("image", np.uint32), ("coord", np.uint32)])
        u["image"] = image_idx
        u["coord"] = coords
        u_rows.append(u)

        pos = np.flatnonzero(valid & (np.asarray(y) > 0)).astype(np.uint32)
        p = np.empty(len(pos), dtype=[("image", np.uint32), ("coord", np.uint32)])
        p["image"] = image_idx
        p["coord"] = pos
        p_rows.append(p)

    P = np.concatenate(p_rows) if p_rows else np.empty(0, dtype=[("image", np.uint32), ("coord", np.uint32)])
    U = np.concatenate(u_rows) if u_rows else np.empty(0, dtype=[("image", np.uint32), ("coord", np.uint32)])
    return P, U


class ShuffledSampler:
    """Endless reshuffling iterator over a structured array.

    With ``seed`` given, the sampler owns a private RandomState and its
    full position is resumable: the state is just (seed, #shuffles done,
    cursor), and :meth:`load_state_dict` replays the shuffles from the
    pristine enumerate order — O(#shuffles * n) instead of serialising the
    multi-megabyte permuted coordinate array into every checkpoint.
    """

    def __init__(self, x: np.ndarray, random=np.random, seed: int = None):
        self.x = x
        if seed is not None:
            random = np.random.RandomState(seed)
        self._seed = seed
        self._shuffles = 0
        self.random = random
        self.i = len(self.x)

    def __len__(self):
        return len(self.x)

    def __next__(self):
        if self.i >= len(self.x):
            self.random.shuffle(self.x)
            self._shuffles += 1
            self.i = 0
        sample = self.x[self.i]
        self.i += 1
        return sample

    def __iter__(self):
        return self

    def state_dict(self):
        if self._seed is None:
            raise ValueError(
                "ShuffledSampler state is only resumable when constructed "
                "with an explicit seed (shared-RNG shuffles can't be replayed)"
            )
        return {"seed": self._seed, "shuffles": self._shuffles, "i": self.i}

    def load_state_dict(self, sd) -> None:
        """Replay onto a freshly-constructed sampler (pristine `x` order)."""
        if self._shuffles != 0:
            raise ValueError("load_state_dict requires a fresh sampler")
        if self._seed != sd["seed"]:
            raise ValueError(
                f"seed mismatch: sampler {self._seed}, checkpoint {sd['seed']}"
            )
        self.random = np.random.RandomState(self._seed)
        for _ in range(sd["shuffles"]):
            self.random.shuffle(self.x)
        self._shuffles = sd["shuffles"]
        self.i = sd["i"]


class StratifiedCoordinateSampler:
    """Weighted P/U draw with history-debt correction.

    Parity: sampler.py:80-155.  `labels` is a list of groups, each a list of
    2-D 0/1 target arrays.  Emits packed integer indices.
    """

    def __init__(self, labels, balance=0.5, size=None, random=np.random,
                 margin_lo: int = 72, margin_hi: int = 140):
        groups = []
        weights = np.zeros(len(labels) * 2)
        proportions = np.zeros((len(labels), 2))
        i = 0
        for group in labels:
            P, U = enumerate_pu_coordinates(group, margin_lo, margin_hi)
            # Private per-group RNGs with seeds derived from the master
            # stream: every group's shuffle history is replayable, making
            # the whole sampler resumable (state_dict below).
            groups.append(ShuffledSampler(P, seed=int(random.randint(2 ** 31 - 1))))
            groups.append(ShuffledSampler(U, seed=int(random.randint(2 ** 31 - 1))))

            proportions[i // 2, 0] = (len(U) - len(P)) / max(len(U), 1)
            proportions[i // 2, 1] = len(P) / max(len(U), 1)

            p = balance if balance is not None else proportions[i // 2, 1]
            weights[i] = p / len(labels)
            weights[i + 1] = (1 - p) / len(labels)
            i += 2

        # Empty strata (e.g. every labelled particle inside the border
        # margins, or a micrograph too small to have any unlabelled region)
        # must never be drawn: a draw would index an empty array deep in
        # the hot loop.  Zero their weight and renormalise; the reference
        # crashes here (sampler.py:119-146 indexes x[0] unguarded).
        sizes = np.array([len(g) for g in groups])
        if (sizes == 0).any():
            empty = [
                f"group {k // 2} {'P' if k % 2 == 0 else 'U'}"
                for k in np.flatnonzero(sizes == 0)
            ]
            logging.getLogger("sampler").warning(
                "stratified sampler: %s empty (labels inside the border "
                "margins, or the micrograph is smaller than the margin "
                "frame); reweighting the remaining strata",
                ", ".join(empty),
            )
            weights[sizes == 0] = 0.0
            total = weights.sum()
            if total <= 0:
                raise ValueError(
                    "stratified sampler: no usable coordinates in any "
                    "stratum — all labelled particles fall inside the "
                    "border margins and no unlabelled region remains"
                )
            weights = weights / total

        if size is None:
            usable = weights > 0
            size = int(np.round(np.min(sizes[usable] / weights[usable])))

        self.groups = groups
        self.weights = weights
        self.proportions = proportions
        self.size = size
        self.history = np.zeros_like(self.weights)
        self.random = random

    def __len__(self):
        return self.size

    def __next__(self) -> int:
        n = self.history.sum()
        weights = self.weights
        if n > 0:
            weights = weights - self.history / n
            weights[weights < 0] = 0
            n = weights.sum()
            if n > 0:
                weights = weights / n
            else:
                # Uniform fallback over the DRAWABLE strata only (empty
                # strata keep base weight 0 and must stay unreachable).
                usable = (self.weights > 0).astype(np.float64)
                weights = usable / usable.sum()

        i = self.random.choice(len(weights), p=weights)
        self.history[i] += 1
        if np.all(self.history / self.history.sum() == self.weights):
            self.history[:] = 0

        sample = next(self.groups[i])
        g = i // 2
        j, c = sample
        return pack_index(g, j, c)

    def __iter__(self) -> Iterator[int]:
        for _ in range(self.size):
            yield next(self)

    def sample_batch(self, batch_size: int) -> np.ndarray:
        """Draw a batch of packed indices (int64)."""
        return np.fromiter(
            (next(self) for _ in range(batch_size)), dtype=np.int64, count=batch_size
        )

    def state_dict(self):
        """Full resumable state: master RNG + history debt + every group's
        replayable shuffle position.  The reference drops this on resume
        (train.py:975-979); serialised here so a killed-and-resumed run
        draws the identical next batches."""
        return {
            "rng_state": self.random.get_state(),
            "history": self.history.copy(),
            "groups": [g.state_dict() for g in self.groups],
        }

    def load_state_dict(self, sd) -> None:
        self.random.set_state(sd["rng_state"])
        self.history[:] = sd["history"]
        if len(sd["groups"]) != len(self.groups):
            raise ValueError(
                f"group count mismatch: sampler {len(self.groups)}, "
                f"checkpoint {len(sd['groups'])} — dataset changed?"
            )
        for g, gsd in zip(self.groups, sd["groups"]):
            g.load_state_dict(gsd)


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
