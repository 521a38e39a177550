"""What ``correct`` must catch, on the CPU at a tiny size with the look for
a card skipped: the control (the plain reference computed in float8, one
step below the configuration's bf16) put in the program's place, and the
faults a pick or denoise cell can have: an answer altered where it is
produced, and a pick dropped.  Each run must come out not correct.

On the H100 the same control ran at the cells' own size through
``gpubench/readings.py`` (PERF.md gives the readings); the `cuda` test
here repeats that for one seed of each side."""

import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gpubench.bench import run_cell
from gpubench.harness import find_cell
from gpubench.reference import model as ref

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
SEED = 2 ** 31 + 5


def run(root, name, cell=None):
    out, err = io.StringIO(), io.StringIO()
    run_cell(cell or find_cell(name, root), SEED, 0.5, False, "cpu", out=out,
             err=err)
    return json.loads(out.getvalue().strip().splitlines()[-1])


def control_in_place(monkeypatch, cell):
    """Every request answered by the control (the reference one precision
    step below the configuration's) on the same micrograph."""
    entry, held = cell.entry, {}
    real = entry.prepare

    def prepare(*args):
        held["prep"] = real(*args)
        return held["prep"]

    def call(picker, path):
        prep = held["prep"]
        return entry.control(cell, prep, prep.items.index(path), "cpu")

    monkeypatch.setattr(entry, "prepare", prepare)
    monkeypatch.setattr(entry, "call", call)


@pytest.mark.parametrize("name", ["pick1k.joint_r8", "denoise1k.dn_ssdn"])
def test_sound_run_is_correct(tiny_root, name):
    assert run(tiny_root, name)["correct"] is True


@pytest.mark.parametrize("name", ["pick1k.joint_r8", "denoise1k.dn_ssdn"])
def test_control_is_not_correct(tiny_root, name, monkeypatch):
    cell = find_cell(name, tiny_root)
    control_in_place(monkeypatch, cell)
    res = run(tiny_root, name, cell)
    assert res["correct"] is False
    failed = [k for k, c in res["checks"].items() if c["value"] > c["limit"]]
    assert failed, res["checks"]


def _patch_nms(monkeypatch, alter):
    from spr_pick_tpu_torch import api

    real = api.Picker._nms

    def broken(self, heatmap):
        scores, coords = real(self, heatmap)
        return alter(scores.copy(), coords.copy())

    monkeypatch.setattr(api.Picker, "_nms", broken)


def test_altered_pick_is_not_correct(tiny_root, monkeypatch):
    """Every pick's score halved where K1's list is read back (the table's
    order kept, so only the scores can show it).  Rounding to bf16 alone
    moves a pick's score by some percent on these random maps, so a
    fault has to pass a few such units to show (PERF.md)."""
    def alter(scores, coords):
        return scores * 0.5, coords

    _patch_nms(monkeypatch, alter)
    res = run(tiny_root, "pick1k.joint_r8")
    assert res["correct"] is False
    assert res["checks"]["score_vs_bf16"]["value"] > \
        res["checks"]["score_vs_bf16"]["limit"]


def test_dropped_pick_is_not_correct():
    """The best pick left out of a table leaves pixels uncovered.  On a
    map of separate blobs (as a 1024^2 map's picks stand; a 128^2 random
    map's few picks crowd its border frame), its rounded twin a little
    off: the table greedy NMS makes has none, the table without its best
    pick has some."""
    from gpubench.harness import load_json

    config = load_json(os.path.join(ROOT, "gpubench", "configs",
                                    "joint_r8.json"))
    entry = find_cell("pick1k.joint_r8").entry
    yy, xx = torch.meshgrid(torch.arange(160.0), torch.arange(160.0),
                            indexing="ij")
    hm = torch.full((160, 160), 1e-4)
    for (y, x), peak in zip([(60, 60), (60, 100), (100, 60), (100, 100)],
                            [0.9, 0.6, 0.4, 0.2]):
        hm += peak * torch.exp(-((yy - y) ** 2 + (xx - x) ** 2) / 18.0)
    hm_unit = hm + 1e-3 * torch.randn(160, 160,
                                      generator=torch.Generator().manual_seed(1))
    scores, rows, cols = ref.greedy_nms(hm, 15, 0.02)

    def uncovered(keep):
        return entry.uncovered_px(
            hm, hm_unit, torch.as_tensor(rows[keep]),
            torch.as_tensor(cols[keep]), torch.as_tensor(scores[keep]),
            config)

    keep = np.ones(len(scores), bool)
    assert uncovered(keep) == 0
    keep[0] = False
    assert uncovered(keep) > 0


def test_altered_denoised_pixels_are_not_correct(tiny_root, monkeypatch):
    """A few denoised pixels moved by 0.5 where the image is produced."""
    from spr_pick_tpu_torch import api

    real = api.Picker._denoised

    def broken(outputs, shape):
        den = real(outputs, shape).copy()
        den[10, 10:14] += 0.5
        return den

    monkeypatch.setattr(api.Picker, "_denoised", staticmethod(broken))
    res = run(tiny_root, "denoise1k.dn_ssdn")
    assert res["correct"] is False
    assert res["checks"]["den_max_vs_bf16"]["value"] > \
        res["checks"]["den_max_vs_bf16"]["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pick1k.joint_r8", "denoise1k.dn_ssdn"])
def test_control_at_full_size_on_the_card(name, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control at the cell's size")
    out = str(tmp_path / "r.jsonl")
    subprocess.run([sys.executable, "gpubench/readings.py", "--workload", name,
                    "--seeds", "4000000001", "--control-seeds", "4000000002",
                    "--out", out], cwd=ROOT, check=True, timeout=600)
    with open(out) as f:
        recs = [json.loads(x) for x in f]
    limits = find_cell(name).limits
    prog = next(r for r in recs if r.get("side") == "program")
    ctl = next(r for r in recs if r.get("side") == "control")
    for k, lim in limits.items():
        assert prog[k] <= lim["limit"], (k, prog[k])
    assert any(ctl[k] > lim["limit"] for k, lim in limits.items()), ctl
