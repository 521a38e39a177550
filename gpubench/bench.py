"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

The cell's entry (`gpubench/entries/<entry>.py`, named by its traffic mix)
sets up the program and the items a request sends, from the seed.  The
window is a closed loop with one client (`gpubench/requests.py`): each
request is sent when the previous one has returned, for ``seconds``
seconds, cycling through the items in an order drawn from the seed, after
the mix's ``warmup`` requests.  With ``trace`` a slice of further
requests runs under torch.profiler once the window has closed, and the
per-layer metrics are read from that slice (and the rate from the
window); without it the entry's end-to-end readings of the window and
``setup_s`` are reported.

After the window the peak device memory is read, the program is freed,
and a sample of the finished requests drawn from the seed is judged
against the plain reference by the entry.
"""

from __future__ import annotations

import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch

from gpubench.harness import Cell, load_json, read_per_layer
from gpubench.requests import Window
from gpubench.trace import Trace, breakdown

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "spr_pick_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def use_checkout_caches(root: str) -> None:
    """Every kernel and build cache at a fixed path inside the checkout
    (K1 builds into ``build/torch_kernels`` beside the package itself)."""
    base = os.path.join(root, "build", "gpubench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi: not read"


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def check(cell: Cell, prep, sample, device):
    """The numbers of the sampled answers (the largest over the sample),
    each with its limit."""
    worst: Dict[str, float] = {}
    for idx, ans in sample:
        for k, v in cell.entry.judge(cell, prep, idx, ans, device).items():
            worst[k] = max(worst.get(k, -float("inf")), v)
    checks = {}
    for k, v in worst.items():
        limit = (0.0 if k in cell.entry.EXACT
                 else cell.limits.get(k, {}).get("limit"))
        checks[k] = {"value": v, "limit": limit}
    return checks


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: Optional[float] = None,
             out=None, err=None) -> Dict:
    """One run; prints the check lines on ``err`` and the result line on
    ``out``, and returns the result."""
    out, err = out or sys.stdout, err or sys.stderr
    t0 = time.perf_counter() if t0 is None else t0
    mix, entry = cell.traffic, cell.entry
    cuda = torch.device(device).type == "cuda"
    if cuda:
        use_checkout_caches(cell.root)
    tmp = tempfile.mkdtemp(prefix="gpubench-")
    try:
        prep = entry.prepare(cell, seed, device, tmp)
        order = np.random.default_rng([int(seed), 1]).permutation(
            len(prep.items))
        win = Window(entry, prep.program, prep.items, order, seed,
                     int(mix["checked"]))
        for i in range(int(mix["warmup"])):
            entry.call(prep.program, prep.items[int(order[i % len(order)])])
        _sync(device)
        setup_s = time.perf_counter() - t0

        w0 = time.perf_counter()
        deadline = w0 + seconds
        while time.perf_counter() < deadline:
            win.one()
        window_s = time.perf_counter() - w0
        lat = list(win.latencies)
        done = len(lat)
        summary = None
        if trace:
            # The traced slice follows the window, so the profiler's own
            # start and its reduction of the trace stay out of it.
            with Trace() as tr:
                for _ in range(int(mix["traced_requests"])):
                    win.one()
            summary = tr.summary
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        win.program = None
        prep.release()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        checks = check(cell, prep, win.sample, device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    found = forbidden_modules()
    if found:
        print(f"gpubench: JAX or the JAX package is loaded: {found}", file=err)
        raise SystemExit(3)

    if trace:
        ctx = {"cell": cell, "trace": summary,
               "traced_requests": int(mix["traced_requests"]),
               "traced_sizes": win.sizes[done:],
               # A rate read off the CPU is no device's: no share of a peak.
               "rate": done / window_s if done and cuda else None,
               "peaks": load_json(os.path.join(cell.root, "gpubench",
                                               "peaks.json"))}
        metrics = read_per_layer(cell, ctx)
        if cuda:
            print(f"gpubench: card {card_line()}", file=err)
    else:
        e2e = {"setup_s": setup_s}
        if done:
            e2e.update(entry.end_to_end(lat, win.sizes[:done], window_s, err))
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in e2e}
    correct = (done > 0 and win.failed == 0 and bool(checks)
               and all(c["limit"] is not None and c["value"] <= c["limit"]
                       for c in checks.values()))
    result = {
        "correct": correct, "attempted": win.attempted,
        "failed": win.failed, "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": cell.chips if cuda else 1,
                   "memory_peak_bytes": int(peak)},
    }
    if trace:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = breakdown(summary)
    result["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)
    return result
