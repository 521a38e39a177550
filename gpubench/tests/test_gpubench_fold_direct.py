"""The reader of ``fold_direct.mic`` (`gpubench/metrics/`, ``source``
``program_counter``) on a tiny CPU run: the share of the run's U-Net conv
step inputs that their producers wrote in place, read as on the card."""

import io
import json

import pytest

from gpubench.bench import run_cell
from gpubench.harness import find_cell

# What the traced slice gives on the card, as far as the reader looks.
ON_CARD = {"busy_s": 0.0, "window_s": 1.0, "kernels": {}, "ops": {},
           "idle_gaps": [], "device_ops": 1}
COUNTERS = ("fold.direct", "fold.staged")


@pytest.fixture(scope="module")
def denoise_run(tmp_path_factory):
    """One traced denoise run on the CPU: bf16 inference, so every
    hand-off of the fold is written in place (the plain versions)."""
    from conftest import tiny_root

    # The fixture's function, called once for the module's run.
    root = tiny_root.__wrapped__(tmp_path_factory.mktemp("fold_direct"))
    cell = find_cell("denoise1k.dn_ssdn", root)
    out = io.StringIO()
    run_cell(cell, 2 ** 31 + 29, 0.3, True, "cpu", out=out, err=io.StringIO())
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    return cell, res


def test_fold_direct_share(monkeypatch, denoise_run):
    """1.0 over the run's recorded spans; with every other request's
    hand-offs moved to ``fold.staged``: 0.5; without the counters (the
    parent's program), off the card or with no device op traced: None."""
    from spr_pick_tpu_torch.utils import profiling

    cell, res = denoise_run
    assert res["correct"] is True
    # Off the card the line carries no per-layer metric.
    assert "fold_direct.mic" not in res["metrics"]
    reader = cell.readers["fold_direct.mic"]
    ctx = {"cell": cell, "trace": ON_CARD}
    assert reader.read(ctx) == 1.0

    recs = profiling.spans()
    opened = max(r.start_ns for r in recs if r.name == "spr.open")
    roots = [r for r in recs if r.name == "spr.request" and r.parent is None
             and r.start_ns >= opened]
    assert len(roots) >= 2
    assert all(r.attrs["fold.direct"] == 25
               and r.attrs.get("fold.staged", 0) == 0 for r in roots)
    moved = {r.span_id for r in roots[1::2]}
    unpaired = {roots[-1].span_id} if len(roots) % 2 else set()

    def staged(r):
        attrs = dict(r.attrs, **{"fold.direct": 0,
                                 "fold.staged": r.attrs["fold.direct"]})
        return r._replace(attrs=attrs)

    monkeypatch.setattr(profiling, "spans", lambda: [
        staged(r) if r.span_id in moved else r
        for r in recs if r.span_id not in unpaired])
    assert reader.read(ctx) == 0.5

    def without(r):
        return r._replace(attrs={k: v for k, v in r.attrs.items()
                                 if k not in COUNTERS})

    monkeypatch.setattr(profiling, "spans",
                        lambda: [without(r) for r in recs])
    assert reader.read(ctx) is None
    monkeypatch.setattr(profiling, "spans", lambda: recs)
    for trace in (None, dict(ON_CARD, device_ops=0)):
        assert reader.read({"cell": cell, "trace": trace}) is None
