"""Tracing: `torch.profiler` capture of a window of work.

The port of `spr_pick_tpu/utils/profiling.py` (whose `jax.profiler` trace
the JAX trainer starts and stops around its first print window,
train.py:559-562,611-615).  The trainer's ``profile=True`` (``--profile``)
starts a capture before its first step and writes it when the first print
window closes, as `<run_dir>/profile/trace.json` (Chrome trace format, for
Perfetto or chrome://tracing).  CUDA activity is traced when the process
has a GPU.
"""

from __future__ import annotations

import os

import torch


class Trace:
    """One profiler capture: started at construction, written by `stop`."""

    def __init__(self, log_dir: str):
        from torch.profiler import ProfilerActivity, profile

        self.log_dir = log_dir
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.start()

    def stop(self) -> str:
        """End the capture and write it; returns the trace's path."""
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()
        os.makedirs(self.log_dir, exist_ok=True)
        path = os.path.join(self.log_dir, "trace.json")
        self._prof.export_chrome_trace(path)
        return path
