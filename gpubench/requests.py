"""The closed loop with one client that an entry's requests run in, and
the end-to-end readings of a window of requests."""

from __future__ import annotations

import statistics
import time
import traceback
from typing import Dict, List

import numpy as np


class Window:
    """One client: each request is sent when the one before has returned,
    cycling through ``items`` in ``order``.  Keeps every latency, every
    answer's size, and a reservoir of ``keep`` (item index, answer) pairs
    drawn from ``seed``."""

    def __init__(self, entry, program, items, order, seed: int, keep: int):
        self.entry, self.program, self.items, self.order = (
            entry, program, items, order)
        self.latencies: List[float] = []
        self.attempted = self.failed = 0
        self.sizes: List[int] = []
        self.sample = []
        self.keep = keep
        self.rng = np.random.default_rng([int(seed), 2])
        self.k = 0

    def one(self) -> None:
        idx = int(self.order[self.k % len(self.order)])
        self.k += 1
        self.attempted += 1
        t = time.perf_counter()
        try:
            ans = self.entry.call(self.program, self.items[idx])
        except Exception:   # a failed request is counted, and the run goes on
            self.failed += 1
            if self.failed == 1:
                traceback.print_exc()
            return
        self.latencies.append(time.perf_counter() - t)
        self.sizes.append(self.entry.size(ans))
        n = len(self.latencies)
        if len(self.sample) < self.keep:
            self.sample.append((idx, ans))
        else:
            j = int(self.rng.integers(n))
            if j < self.keep:
                self.sample[j] = (idx, ans)


def mic_metrics(latencies: List[float], sizes: List[int], window_s: float,
                err) -> Dict[str, float]:
    """``mic_rate``: micrographs completed in the window over its seconds;
    ``mic_p95_ms``: the 95th percentile of every request's time from
    submit to result.  The median, the count and the answers' mean size
    go to ``err``."""
    p95 = 1e3 * float(np.percentile(latencies, 95))
    print(f"gpubench: answers of {statistics.mean(sizes)} picks or pixels "
          f"on average", file=err)
    print(f"gpubench: latency median {1e3 * statistics.median(latencies)} "
          f"ms, p95 {p95} ms, {len(latencies)} requests in {window_s} s",
          file=err)
    return {"mic_rate": len(latencies) / window_s, "mic_p95_ms": p95}
