"""Tracing: `torch.profiler` capture of a window of work, and the port's
own spans and counters.

The port of `spr_pick_tpu/utils/profiling.py` (whose `jax.profiler` trace
the JAX trainer starts and stops around its first print window,
train.py:559-562,611-615).  The trainer's ``profile=True`` (``--profile``)
starts a capture before its first step and writes it when the first print
window closes, as `<run_dir>/profile/trace.json` (Chrome trace format, for
Perfetto or chrome://tracing).  CUDA activity is traced when the process
has a GPU.

`span` and `count` mark the layer boundaries of the `Picker`'s requests
and of its set-up (`api.py`, `data/loader.py`, `ops/nms.py`,
`ops/nms_cuda.py`).  They are always on: each span is kept in a bounded
ring in memory (`spans()`), each count in a dict (`counters()`).  A span
is also entered as a profiler range, so under any torch.profiler session
(`Trace`, ``train start --profile`` or an operator's own) it is a CPU
event on the clock of the device's events.  The range is a plain
`RecordFunction`, not a user annotation, so the profiler adds no
device-side event for it.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from typing import Dict, List, NamedTuple, Optional

import torch

# A range the profiler records as a CPU event and never as a GPU user
# annotation (torch.profiler.record_function is one, and would mark the
# device busy from a range's first kernel to its last).  About 1 us an
# enter and exit with no profiler running.
_PROFILER_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None)
RING = 65536   # spans kept; a 51-s benchmark run of picking makes ~4,000


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


class SpanRecord(NamedTuple):
    """A finished span: ``start_ns`` and ``end_ns`` from
    `time.perf_counter_ns`; ``parent`` the enclosing span's ``span_id``
    (None at a root); ``request`` the root's ``span_id``, shared by every
    span under it."""
    name: str
    start_ns: int
    end_ns: int
    span_id: int
    parent: Optional[int]
    request: int
    attrs: Dict


class _Span:
    __slots__ = ("rec", "name", "attrs", "span_id", "parent", "request",
                 "start", "range")

    def __init__(self, rec: "Recorder", name: str, attrs: Dict):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self) -> Dict:
        stack = self.rec._stack()
        up = stack[-1] if stack else None
        self.span_id = next(self.rec._ids)
        self.parent = up.span_id if up else None
        self.request = up.request if up else self.span_id
        stack.append(self)
        self.range = None
        if _PROFILER_RANGE is not None:
            self.range = _PROFILER_RANGE(self.name)
            self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self.attrs

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        self.rec._stack().pop()
        self.rec._ring.append(SpanRecord(self.name, self.start, end,
                                         self.span_id, self.parent,
                                         self.request, self.attrs))
        return False


class Recorder:
    """Spans and counters of one process: spans in a ring of ``maxlen``
    records, counters in a dict.  Parents come from a stack per thread."""

    def __init__(self, maxlen: int = RING):
        self._ring = deque(maxlen=maxlen)
        self._counters: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)

    def _stack(self) -> List[_Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, **attrs) -> _Span:
        """``with span(name, **attrs) as attrs:`` records the block; the
        body may add attributes to ``attrs``."""
        return _Span(self, name, attrs)

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to counter ``name``, and to the attribute ``name`` of
        the open root span of this thread, if any (so a reader can tell
        one request's counts from another's)."""
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n
        stack = self._stack()
        if stack:
            root = stack[0].attrs
            root[name] = root.get(name, 0) + n

    def spans(self) -> List[SpanRecord]:
        """The finished spans held, oldest first by their ends."""
        return list(self._ring)

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)


RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count
spans = RECORDER.spans
counters = RECORDER.counters
