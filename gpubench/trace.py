"""The device trace of a bounded slice of a run (torch.profiler, CUPTI),
reduced to what the per-layer readers take: the device's busy time as the
union of its operations' intervals against the slice's wall time, device
seconds by kernel and by the PyTorch op that launched them, and the
longest idle gaps by what the host was doing."""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import torch

NAME_CHARS = 160   # kernel names are templates; keep their heads


def _device_s(evt) -> float:
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0)) / 1e6


class Trace:
    """``with Trace() as t: ...`` profiles the block; ``t.summary`` then
    holds the reduction.  The block's wall time ends after a device
    synchronise."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.summary = summarize(self._prof, wall)
        return False


def _union(spans: List[Tuple[float, float]]):
    """Merged intervals of sorted (start, end) spans."""
    merged = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(prof, wall_s: float) -> Dict:
    events = list(prof.events())
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA]
    cpu = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CPU]
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    merged = _union(spans)
    busy_s = sum(e - s for s, e in merged) / 1e6
    kernels: Dict[str, float] = {}
    for e in dev:
        kernels[e.name] = kernels.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e6
    ops = {}
    for e in prof.key_averages():
        t = _device_s(e)
        if t > 0:
            ops[e.key] = ops.get(e.key, 0.0) + t
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1],
                    merged[i + 1][0]) for i in range(len(merged) - 1)),
                  reverse=True)[:10]
    idle = []
    for length, s, e in gaps:
        mid = (s + e) / 2
        around = [c for c in cpu
                  if c.time_range.start <= mid <= c.time_range.end]
        # The innermost host op at the gap's middle: the latest to start.
        name = (max(around, key=lambda c: c.time_range.start).name
                if around else "host Python outside torch ops")
        idle.append([name[:NAME_CHARS], length / 1e6])
    return {"busy_s": busy_s, "window_s": wall_s, "kernels": kernels,
            "ops": ops, "idle_gaps": idle, "device_ops": len(dev)}


def breakdown(summary: Dict) -> Dict:
    top = sorted(summary["kernels"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k[:NAME_CHARS], v] for k, v in top],
            "idle_gaps": summary["idle_gaps"]}
