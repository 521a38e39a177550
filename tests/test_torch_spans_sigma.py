"""The sigma net's span and counter (`Denoiser._noise_estimate`): a
`var` request opens exactly one ``spr.sigma`` span, inside its forward,
and adds one to ``sigma.calls`` on its root span; a `const` request
opens neither.  ``spr.sigma`` is a user annotation under torch.profiler
(the profiler then records it on the device too); the other spans stay
plain CPU events."""

import time

import numpy as np
import pytest
import torch

from spr_pick_tpu_torch import cfg as cfg_mod
from spr_pick_tpu_torch.api import Picker
from spr_pick_tpu_torch.data import mrc
from spr_pick_tpu_torch.denoiser import Denoiser
from spr_pick_tpu_torch.params import ConfigValue as CV
from spr_pick_tpu_torch.params import NoiseAlgorithm, NoiseValue
from spr_pick_tpu_torch.utils import checkpoint as ckpt
from spr_pick_tpu_torch.utils import profiling

REQUESTS = {
    "process_table": lambda p, mic: p.process_table(mic),
    "pick_many_table": lambda p, mic: p.pick_many_table([mic]),
    "denoise": lambda p, mic: p.denoise(mic),
}


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads: beside five other test workers on the same
    cores, torch's default of one thread a core oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pickers(tmp_path_factory):
    """CPU Pickers on a `var` and a `const` joint checkpoint written by the
    port's own writer, and a 96^2 MRC."""
    d = tmp_path_factory.mktemp("sigma_spans")
    torch.manual_seed(0)
    out = {}
    for value in (NoiseValue.UNKNOWN_VARIABLE, NoiseValue.UNKNOWN_CONSTANT):
        c = cfg_mod.base()
        c[CV.ALGORITHM] = NoiseAlgorithm.SELFSUPERVISED_DENOISING
        c[CV.NOISE_STYLE] = "gauss"
        c[CV.NOISE_VALUE] = value
        c[CV.COMPUTE_DTYPE] = "f32"
        den = Denoiser(c, mode="joint", device="cpu")
        wt = str(d / f"{value.value}.wt")
        ckpt.save_weights(wt, *den.variables(), c, "joint")
        out[value.value] = Picker(wt, device="cpu", threshold=0.0)
    mic = str(d / "mic.mrc")
    mrc.write(mic, np.random.RandomState(0).randn(96, 96).astype(np.float32))
    return out, mic


def _request(pickers, value, kind):
    by_value, mic = pickers
    t0 = time.perf_counter_ns()
    REQUESTS[kind](by_value[value], mic)
    return [r for r in profiling.spans() if r.start_ns >= t0]


@pytest.mark.parametrize("kind", sorted(REQUESTS))
def test_var_request_opens_one_sigma_span(pickers, kind):
    before = profiling.counters().get("sigma.calls", 0)
    recs = _request(pickers, "var", kind)
    root = next(r for r in recs if r.name == "spr.request")
    sigma = [r for r in recs if r.name == "spr.sigma"]
    assert len(sigma) == 1
    by_id = {r.span_id: r for r in recs}
    assert by_id[sigma[0].parent].name == "spr.forward"
    assert sigma[0].request == root.span_id
    assert root.attrs["sigma.calls"] == 1
    assert profiling.counters()["sigma.calls"] - before == 1


@pytest.mark.parametrize("kind", sorted(REQUESTS))
def test_const_request_opens_no_sigma_span(pickers, kind):
    before = profiling.counters().get("sigma.calls", 0)
    recs = _request(pickers, "const", kind)
    root = next(r for r in recs if r.name == "spr.request")
    assert not [r for r in recs if r.name == "spr.sigma"]
    assert "sigma.calls" not in root.attrs
    assert profiling.counters().get("sigma.calls", 0) == before


def test_sigma_span_is_a_user_annotation_under_the_profiler(pickers):
    from torch.profiler import ProfilerActivity, profile

    by_value, mic = pickers
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        by_value["var"].process_table(mic)
    events = {}
    for e in prof.events():
        events.setdefault(e.name, []).append(e)
    assert len(events["spr.sigma"]) == 1
    assert events["spr.sigma"][0].is_user_annotation is True
    for name in ("spr.request", "spr.forward", "spr.fetch"):
        assert events[name], name
        assert not any(getattr(e, "is_user_annotation", False)
                       for e in events[name]), name


@pytest.mark.parametrize("on_device", [False, True])
def test_on_device_span_records_as_any_span(on_device):
    rec = profiling.Recorder()
    with rec.span("root", micrographs=1):
        with rec.span("inner", on_device=on_device, k=2) as attrs:
            rec.count("n")
            attrs["late"] = 3
    inner, root = rec.spans()
    assert (inner.name, root.name) == ("inner", "root")
    assert inner.parent == root.span_id and inner.attrs == {"k": 2, "late": 3}
    assert root.attrs == {"micrographs": 1, "n": 1}
