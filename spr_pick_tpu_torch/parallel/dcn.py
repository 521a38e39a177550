"""Work lists and metrics across processes: each rank evaluates its shard
of the micrographs, and the metric accumulators are summed over the ranks.

The port's copy of `spr_pick_tpu/parallel/dcn.py` (`host_shard`,
`shard_sizes`, the metric-vector codec and `allreduce_metrics` with its
``base`` delta rule), on `torch.distributed` in place of JAX's process
runtime.  A process outside any group is rank 0 of 1, so the same
evaluator code runs everywhere.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def process_info() -> Tuple[int, int]:
    """(rank, size) of the default process group; (0, 1) without one."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def host_shard(items: Sequence, index: int = None, count: int = None) -> List:
    """Deterministic round-robin partition of a work list across ranks.

    Round-robin (rather than contiguous blocks) keeps the load even when
    micrograph sizes follow the collection order.  Every item is owned by
    exactly one rank; ranks with ``i >= len(items)`` get the empty list.
    """
    if index is None or count is None:
        index, count = process_info()
    if count <= 1:
        return list(items)
    return [it for j, it in enumerate(items) if j % count == index]


def shard_sizes(n_items: int, count: int) -> List[int]:
    """Items per rank under :func:`host_shard`."""
    return [len(range(i, n_items, count)) for i in range(count)]


def metrics_to_vector(history, keys: Sequence[str]) -> np.ndarray:
    """Metric accumulators -> a summable float64 vector
    [total_k0, ..., total_kn, n_k0, ..., n_kn].

    Empty metrics contribute zeros, so a rank whose shard never produced a
    metric merges as a no-op.  A plain number (the item counter
    ``history["n"]``) rides in the totals slot with NaN in its count slot
    as a type marker: NaN survives the sum, so the write-back restores a
    plain number.
    """
    totals = np.zeros(len(keys), np.float64)
    counts = np.zeros(len(keys), np.float64)
    for j, k in enumerate(keys):
        m = history[k]
        if isinstance(m, (int, float, np.integer, np.floating)):
            totals[j] = float(m)
            counts[j] = np.nan
            continue
        if m.total is not None:
            totals[j] = float(np.asarray(m.total))
        counts[j] = float(m.n)
    return np.concatenate([totals, counts])


def vector_to_metrics(history, keys: Sequence[str], vec: np.ndarray) -> None:
    """Write a (merged) metric vector back into the history, in place."""
    k = len(keys)
    for j, key in enumerate(keys):
        nval = vec[k + j]
        if np.isnan(nval):
            total = float(vec[j])
            history[key] = int(round(total)) if total.is_integer() else total
            continue
        m = history[key]
        n = int(round(nval))
        if n == 0:
            m.reset()
        else:
            m.total = np.asarray(vec[j], np.float64)
            m.n = n


def _all_sum(vec: np.ndarray) -> np.ndarray:
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.from_numpy(vec).to(device)
    dist.all_reduce(t)
    return t.cpu().numpy()


def allreduce_metrics(history, keys: Sequence[str], base=None):
    """Sum metric accumulators across all ranks, in place.

    Identity outside a group of several ranks.  ``keys`` must be the same
    on every rank (derive them from the cfg, not from which metrics a shard
    touched): the vectors are summed by position.

    ``base``: the vector this function returned on the PREVIOUS call over
    the same (un-reset) history.  After a merge every rank holds the
    GLOBAL totals, so a later merge exchanges only the per-rank delta since
    (re-summing the full totals would count the global part once per rank).
    Returns the new merged vector to pass as ``base`` next time (None
    outside a group); callers drop the base whenever the history is reset.
    """
    if process_info()[1] <= 1:
        return None
    local = metrics_to_vector(history, keys)
    if base is not None:
        local = local - base  # NaN count-markers pass through
    merged = _all_sum(local)
    if base is not None:
        merged = merged + base
    vector_to_metrics(history, keys, merged)
    return merged
