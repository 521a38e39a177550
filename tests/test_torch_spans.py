"""The port's spans and counters (`spr_pick_tpu_torch/utils/profiling.py`):
the recorder alone, the span tree of the Picker's requests on a CPU
Picker, K1's call counter with its cap retry, K1's library load, and the
spans as plain CPU events under torch.profiler."""

import time
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from spr_pick_tpu_torch import cfg as cfg_mod
from spr_pick_tpu_torch.api import Picker
from spr_pick_tpu_torch.data import mrc
from spr_pick_tpu_torch.denoiser import Denoiser
from spr_pick_tpu_torch.ops import nms, nms_cuda
from spr_pick_tpu_torch.params import ConfigValue as CV
from spr_pick_tpu_torch.params import NoiseAlgorithm, NoiseValue
from spr_pick_tpu_torch.utils import checkpoint as ckpt
from spr_pick_tpu_torch.utils import profiling

REQUEST_TREE = {"spr.load": "spr.request", "spr.load.read": "spr.load",
                "spr.forward": "spr.request", "spr.fetch": "spr.request"}


def test_nesting_parents_and_request_ids():
    rec = profiling.Recorder()
    with rec.span("a", micrographs=2) as attrs:
        with rec.span("b"):
            with rec.span("c"):
                pass
        with rec.span("d"):
            pass
        attrs["late"] = 1
    with rec.span("e"):
        pass
    got = {r.name: r for r in rec.spans()}
    assert [r.name for r in rec.spans()] == ["c", "b", "d", "a", "e"]
    a, e = got["a"], got["e"]
    assert a.parent is None and a.request == a.span_id
    assert a.attrs == {"micrographs": 2, "late": 1}
    assert got["b"].parent == got["d"].parent == a.span_id
    assert got["c"].parent == got["b"].span_id
    assert {got[n].request for n in "abcd"} == {a.span_id}
    assert e.parent is None and e.request == e.span_id != a.span_id
    for r in rec.spans():
        assert r.start_ns <= r.end_ns
    assert a.start_ns <= got["b"].start_ns and got["d"].end_ns <= a.end_ns


def test_span_closes_on_error():
    rec = profiling.Recorder()
    with pytest.raises(ValueError):
        with rec.span("outer"):
            with rec.span("inner"):
                raise ValueError("x")
    with rec.span("next"):
        pass
    assert [r.name for r in rec.spans()] == ["inner", "outer", "next"]
    assert rec.spans()[-1].parent is None


def test_ring_keeps_the_newest():
    rec = profiling.Recorder(maxlen=4)
    for i in range(10):
        with rec.span(f"s{i}"):
            pass
    assert [r.name for r in rec.spans()] == ["s6", "s7", "s8", "s9"]
    assert profiling.RECORDER._ring.maxlen == profiling.RING


def test_counters_and_the_root_attribute():
    rec = profiling.Recorder()
    rec.count("x")
    with rec.span("root"):
        with rec.span("child"):
            rec.count("x", 2)
            rec.count("y")
    assert rec.counters() == {"x": 3, "y": 1}
    root = rec.spans()[-1]
    assert root.name == "root" and root.attrs == {"x": 2, "y": 1}
    assert rec.spans()[0].attrs == {}


@pytest.fixture(scope="module")
def picker(tmp_path_factory):
    """A CPU Picker on a joint checkpoint written by the port's own writer,
    a 96^2 MRC, and the spans of the Picker's open."""
    d = tmp_path_factory.mktemp("spans")
    torch.manual_seed(0)
    c = cfg_mod.base()
    c[CV.ALGORITHM] = NoiseAlgorithm.SELFSUPERVISED_DENOISING
    c[CV.NOISE_STYLE] = "gauss"
    c[CV.NOISE_VALUE] = NoiseValue.UNKNOWN_CONSTANT
    c[CV.COMPUTE_DTYPE] = "f32"
    den = Denoiser(c, mode="joint", device="cpu")
    wt = str(d / "joint.wt")
    ckpt.save_weights(wt, *den.variables(), c, "joint")
    mic = str(d / "mic.mrc")
    mrc.write(mic, np.random.RandomState(0).randn(96, 96).astype(np.float32))
    t0 = time.perf_counter_ns()
    p = Picker(wt, device="cpu", threshold=0.0)
    return p, mic, _since(t0)


def _since(t0):
    return [r for r in profiling.spans() if r.start_ns >= t0]


def _assert_request_tree(recs, micrographs):
    roots = [r for r in recs if r.name == "spr.request"]
    assert len(roots) == 1
    root = roots[0]
    assert root.parent is None and root.attrs["micrographs"] == micrographs
    by_id = {r.span_id: r for r in recs}
    names = {r.name for r in recs}
    assert set(REQUEST_TREE) <= names
    for r in recs:
        assert r.request == root.span_id
        if r.name in REQUEST_TREE:
            assert by_id[r.parent].name == REQUEST_TREE[r.name], r
    load = next(r for r in recs if r.name == "spr.load")
    assert load.attrs["minflt"] >= 0


def test_picker_open_is_a_span(picker):
    opened = picker[2]
    assert [r.name for r in opened] == ["spr.open"]
    assert opened[0].parent is None and opened[0].end_ns > opened[0].start_ns


def test_pick_many_table_request_tree(picker):
    p, mic, _ = picker
    t0 = time.perf_counter_ns()
    table = p.pick_many_table([mic])
    recs = _since(t0)
    _assert_request_tree(recs, 1)
    root = next(r for r in recs if r.name == "spr.request")
    assert root.attrs["k1.calls"] == 1
    assert len(table["score"]) > 0


def test_denoise_request_tree(picker):
    p, mic, _ = picker
    t0 = time.perf_counter_ns()
    den = p.denoise(mic)
    recs = _since(t0)
    _assert_request_tree(recs, 1)
    root = next(r for r in recs if r.name == "spr.request")
    assert "k1.calls" not in root.attrs
    assert den.shape == (96, 96)


def test_cap_retry_counts_two_k1_calls():
    """Six separate peaks in a buffer of four: the capped list is run
    again with eight slots, the plain K1 twice."""
    hm = torch.zeros(48, 48)
    for k in range(6):
        hm[8 * k + 4, 8 * k + 4] = 1.0 - 0.01 * k
    before = profiling.counters().get("k1.calls", 0)
    t0 = time.perf_counter_ns()
    with profiling.span("test.root"):
        scores, _ = nms.nms_to_host(hm, 2, threshold=0.5, max_peaks=4)
    assert len(scores) == 6
    assert profiling.counters()["k1.calls"] - before == 2
    root = _since(t0)[-1]
    assert root.name == "test.root" and root.attrs["k1.calls"] == 2
    fetch = [r for r in _since(t0) if r.name == "spr.fetch"]
    assert len(fetch) == 1 and fetch[0].parent == root.span_id


@pytest.mark.parametrize("built", [True, False])
def test_k1_library_load_is_a_span(monkeypatch, built):
    lib = nms_cuda._Library()
    monkeypatch.setattr(lib, "build", lambda: (Path("libspr_nms.so"), built))
    monkeypatch.setattr(nms_cuda.ctypes, "CDLL", lambda path: mock.Mock())
    t0 = time.perf_counter_ns()
    first = lib.get()
    assert lib.get() is first
    loads = [r for r in _since(t0) if r.name == "spr.k1.load"]
    assert len(loads) == 1 and loads[0].attrs == {"built": built}


def test_spans_are_plain_cpu_events_under_the_profiler():
    from torch.profiler import ProfilerActivity, profile

    names = ("spr.test.outer", "spr.test.inner")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span(names[0]):
            with profiling.span(names[1]):
                torch.ones(8).add_(1)
    got = [e for e in prof.events() if e.name in names]
    assert sorted(e.name for e in got) == sorted(names)
    for e in got:
        assert e.device_type == torch.autograd.DeviceType.CPU
        assert getattr(e, "is_user_annotation", False) is False
