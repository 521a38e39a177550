"""The readers of the program's spans and counters (`gpubench/metrics/`,
``source`` ``program_span`` or ``program_counter``) on tiny CPU runs:
each reads what applies to its cell from the run's own spans, and a run
off the card reports none of them."""

import io
import json

import pytest

from gpubench.bench import run_cell
from gpubench.harness import find_cell

SPANS = {"open_s.mic", "decode_ms.mic", "decode_faults.mic", "read_ms.mic",
         "launch_ms.mic", "wait_ms.mic"}
PICK_ONLY = {"k1_load_s.pick", "k1_calls.pick"}
# What the traced slice gives on the card, as far as the readers look.
ON_CARD = {"busy_s": 0.0, "window_s": 1.0, "kernels": {}, "ops": {},
           "idle_gaps": [], "device_ops": 1}


def run_and_read(root, name, seed):
    """One traced run on the CPU, then each span reader of the cell on the
    spans it left, read as on the card."""
    cell = find_cell(name, root)
    out = io.StringIO()
    run_cell(cell, seed, 0.3, True, "cpu", out=out, err=io.StringIO())
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    ctx = {"cell": cell, "trace": ON_CARD}
    read = {m: cell.readers[m].read(ctx) for m in cell.readers
            if m in SPANS | PICK_ONLY}
    return res, read


@pytest.fixture(scope="module")
def two_runs(tmp_path_factory):
    """A pick run, then a denoise run, in one process."""
    from conftest import tiny_root

    # The fixture's function, called once for the module's two runs.
    root = tiny_root.__wrapped__(tmp_path_factory.mktemp("spans"))
    pick = run_and_read(root, "pick1k.joint_r8", 2 ** 31 + 17)
    den = run_and_read(root, "denoise1k.dn_ssdn", 2 ** 31 + 18)
    return root, pick, den


def test_pick_run_reads_its_metrics(two_runs):
    _, (res, read), _ = two_runs
    assert res["correct"] is True
    # Off the card the line carries no per-layer metric.
    assert not set(res["metrics"]) & (SPANS | PICK_ONLY)
    assert set(read) == SPANS | PICK_ONLY
    # K1's library is loaded only on the card (the CPU runs its plain
    # version), so its load has no span here.
    assert read.pop("k1_load_s.pick") is None
    assert read["k1_calls.pick"] == 1.0
    assert read["decode_faults.mic"] >= 0
    for m in SPANS - {"decode_faults.mic"}:
        assert read[m] > 0, m
    assert read["read_ms.mic"] <= read["decode_ms.mic"]


def test_denoise_run_reads_no_k1_metric(two_runs):
    root, _, (res, read) = two_runs
    assert res["correct"] is True
    assert set(read) == SPANS
    assert all(read[m] is not None for m in SPANS)
    assert not PICK_ONLY & set(find_cell("denoise1k.dn_ssdn", root).readers)


def test_each_run_reads_only_its_own_spans(two_runs):
    """After the denoise run the pick cell's K1 counter reader finds no
    call (the pick run's are before the newest open), and the open read is
    the newest one's."""
    from spr_pick_tpu_torch.utils import profiling

    root, (_, pick), (_, den) = two_runs
    cell = find_cell("pick1k.joint_r8", root)
    ctx = {"cell": cell, "trace": ON_CARD}
    assert cell.readers["k1_calls.pick"].read(ctx) is None
    opened = [r for r in profiling.spans() if r.name == "spr.open"]
    newest = max(opened, key=lambda r: r.start_ns)
    assert den["open_s.mic"] == (newest.end_ns - newest.start_ns) / 1e9
    assert cell.readers["open_s.mic"].read(ctx) == den["open_s.mic"]
    assert pick["open_s.mic"] != den["open_s.mic"]


def test_no_spans_read_nothing(monkeypatch, two_runs):
    """A program without spans (the parent of the readers), or a run off
    the card: every reader gives None and none raises."""
    from spr_pick_tpu_torch.utils import profiling

    root = two_runs[0]
    cell = find_cell("pick1k.joint_r8", root)
    for trace in (None, dict(ON_CARD, device_ops=0)):
        ctx = {"cell": cell, "trace": trace}
        for m in SPANS | PICK_ONLY:
            assert cell.readers[m].read(ctx) is None, m
    monkeypatch.delattr(profiling, "spans")
    ctx = {"cell": cell, "trace": ON_CARD}
    for m in SPANS | PICK_ONLY:
        assert cell.readers[m].read(ctx) is None, m
