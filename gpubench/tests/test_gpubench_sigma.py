"""The readers of the sigma net's metrics (`gpubench/metrics/`):
``sigma_calls.process`` (``program_counter``) on a tiny traced CPU run of
``process1k.joint_var``, read as on the card, and ``sigma_ms.process``
(``device_trace``) on the device event the profiler records for the
``spr.sigma`` annotation.  Each reads None where the program has no such
span or counter."""

import io
import json

import pytest

from gpubench.bench import run_cell
from gpubench.harness import find_cell

# What the traced slice gives on the card, as far as the readers look.
ON_CARD = {"busy_s": 0.0, "window_s": 1.0, "kernels": {}, "ops": {},
           "idle_gaps": [], "device_ops": 1}


@pytest.fixture(scope="module")
def process_run(tmp_path_factory):
    """One traced process run on the CPU."""
    from conftest import tiny_root

    # The fixture's function, called once for the module's run.
    root = tiny_root.__wrapped__(tmp_path_factory.mktemp("sigma"))
    cell = find_cell("process1k.joint_var", root)
    out = io.StringIO()
    run_cell(cell, 2 ** 31 + 21, 0.3, True, "cpu", out=out, err=io.StringIO())
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    return cell, res


def test_process_run_answers_and_judges(process_run):
    """Every request answered, every number judged; off the card the line
    carries no per-layer metric."""
    _, res = process_run
    assert res["attempted"] > 0 and res["failed"] == 0
    assert {"score_vs_bf16", "den_l2_vs_bf16", "den_max_vs_bf16",
            "uncovered_px"} <= set(res["checks"])
    for k in ("close_pairs", "border_out", "order_breaks"):
        assert res["checks"][k]["value"] == 0, k
    assert not {"sigma_ms.process", "sigma_calls.process"} & set(
        res["metrics"])


def test_sigma_calls(monkeypatch, process_run):
    """1.0 over the run's spans; None off the card, or on a program that
    keeps no ``sigma.calls`` counter."""
    from spr_pick_tpu_torch.utils import profiling

    cell, _ = process_run
    reader = cell.readers["sigma_calls.process"]
    assert reader.read({"cell": cell, "trace": ON_CARD}) == 1.0
    for trace in (None, dict(ON_CARD, device_ops=0)):
        assert reader.read({"cell": cell, "trace": trace}) is None
    recs = profiling.spans()
    monkeypatch.setattr(profiling, "spans", lambda: [
        r._replace(attrs={k: v for k, v in r.attrs.items()
                          if k != "sigma.calls"}) for r in recs])
    assert reader.read({"cell": cell, "trace": ON_CARD}) is None


def test_sigma_ms(process_run):
    """Device ms a request of the ``spr.sigma`` event; None without it."""
    cell, _ = process_run
    reader = cell.readers["sigma_ms.process"]
    trace = dict(ON_CARD, kernels={"spr.sigma": 0.024, "conv": 1.0})
    assert reader.read({"cell": cell, "trace": trace,
                        "traced_requests": 12}) == pytest.approx(2.0)
    for t in (None, ON_CARD):
        assert reader.read({"cell": cell, "trace": t,
                            "traced_requests": 12}) is None
