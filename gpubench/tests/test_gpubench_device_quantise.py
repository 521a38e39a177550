"""The reader of ``device_quantise.mic`` (`gpubench/metrics/`, ``source``
``program_counter``) on a tiny CPU run: the share of the run's micrographs
whose MRC min-max quantise ran on the device, read as on the card."""

import io
import json

import pytest

from gpubench.bench import run_cell
from gpubench.harness import find_cell

# What the traced slice gives on the card, as far as the reader looks.
ON_CARD = {"busy_s": 0.0, "window_s": 1.0, "kernels": {}, "ops": {},
           "idle_gaps": [], "device_ops": 1}


@pytest.fixture(scope="module")
def denoise_run(tmp_path_factory):
    """One traced denoise run on the CPU, every request an MRC path."""
    from conftest import tiny_root

    # The fixture's function, called once for the module's run.
    root = tiny_root.__wrapped__(tmp_path_factory.mktemp("quantise"))
    cell = find_cell("denoise1k.dn_ssdn", root)
    out = io.StringIO()
    run_cell(cell, 2 ** 31 + 19, 0.3, True, "cpu", out=out, err=io.StringIO())
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    return cell, res


def test_device_quantise_share(monkeypatch, denoise_run):
    """1.0 over the run's recorded spans; with the counter taken off every
    other one of an even number of its requests: 0.5; off the card, or on
    a program without the device quantise: None."""
    from spr_pick_tpu_torch.data import loader
    from spr_pick_tpu_torch.utils import profiling

    cell, res = denoise_run
    assert res["correct"] is True
    # Off the card the line carries no per-layer metric.
    assert "device_quantise.mic" not in res["metrics"]
    reader = cell.readers["device_quantise.mic"]
    ctx = {"cell": cell, "trace": ON_CARD}
    assert reader.read(ctx) == 1.0

    recs = profiling.spans()
    opened = max(r.start_ns for r in recs if r.name == "spr.open")
    roots = [r for r in recs if r.name == "spr.request" and r.parent is None
             and r.start_ns >= opened]
    assert len(roots) >= 2
    dropped = {r.span_id for r in roots[1::2]}
    unpaired = {roots[-1].span_id} if len(roots) % 2 else set()

    def without_count(r):
        attrs = {k: v for k, v in r.attrs.items()
                 if k != "load.device_quantise"}
        return r._replace(attrs=attrs)

    monkeypatch.setattr(profiling, "spans", lambda: [
        without_count(r) if r.span_id in dropped else r
        for r in recs if r.span_id not in unpaired])
    assert reader.read(ctx) == 0.5

    for trace in (None, dict(ON_CARD, device_ops=0)):
        assert reader.read({"cell": cell, "trace": trace}) is None
    monkeypatch.delattr(loader, "minmax_quantize_device")
    assert reader.read(ctx) is None
