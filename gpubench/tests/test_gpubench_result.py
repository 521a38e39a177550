"""A whole run on the CPU at a tiny size (the look for a card skipped):
the result line's keys, its check lines, and the imports of the harness."""

import io
import json
import os
import subprocess
import sys

import pytest

from gpubench.bench import run_cell
from gpubench.harness import find_cell

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run(root, name, trace, seed=2 ** 31 + 99):
    out, err = io.StringIO(), io.StringIO()
    run_cell(find_cell(name, root), seed, 0.5, trace, "cpu", out=out, err=err)
    return json.loads(out.getvalue().strip().splitlines()[-1]), err.getvalue()


@pytest.mark.parametrize("name,e2e", [
    ("pick1k.joint_r8", {"mic_rate", "setup_s"}),
    ("denoise1k.dn_ssdn", {"mic_rate", "mic_p95_ms", "setup_s"})])
def test_result_line(tiny_root, name, e2e):
    res, err = run(tiny_root, name, False)
    assert list(res) == KEYS + ["checks"]
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == e2e
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    tail = err.strip().splitlines()[-len(res["checks"]):]
    assert [ln.split()[1] for ln in tail] == list(res["checks"])
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}


def test_traced_result_line(tiny_root):
    res, _ = run(tiny_root, "pick1k.joint_r8", True)
    assert list(res) == KEYS + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # Off the card nothing reads a device metric.
    assert res["metrics"] == {}


def test_no_card_no_result():
    proc = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", "pick1k.joint_r8",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_run_loads_neither_jax_nor_the_jax_package():
    """After everything a run imports, no loaded module's top-level name is
    JAX's or the JAX package's (compared whole: the port's name begins
    with the JAX package's)."""
    code = (
        "import sys; sys.path.insert(0, '.');"
        "import runpy; runpy.run_path('gpubench/run.py', run_name='probe');"
        "import gpubench.bench, gpubench.readings, gpubench.program;"
        "from gpubench.harness import find_cell;"
        "[find_cell(c) for c in ('pick1k.joint_r8', 'denoise1k.dn_ssdn')];"
        "import spr_pick_tpu_torch.api, spr_pick_tpu_torch.eval;"
        "from gpubench.bench import forbidden_modules;"
        "print(forbidden_modules())")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
