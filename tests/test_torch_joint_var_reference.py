"""The port's `var` joint model held to the benchmark's plain reference
(`gpubench/reference/joint_var.py`), on the CPU in float32, on seeded
random weights at small sizes: the sigma net's map, the per-image noise
level, the denoised image and the picks of `Picker.process_table`, and
the heatmap; the operation counts of `gpubench/counts/joint_var.py`
against the convs the port runs; and the window-by-window reference of
`gpubench/entries/pick_tiled.py` against the port's halo-tiled route.
Imports no JAX.

Tolerances: the port and the reference run the same float32 convs, but
the port in NHWC tensors permuted to NCHW, the rot4 lanes as one batch
and its bias added inside the conv, so sums of up to ~1,300 terms may
round in another order: a few float32 ulps a conv, grown through up to
20 layers.  rtol 1e-4 / atol 1e-5 holds that with room (the largest
gaps seen are ~1e-6); a bf16 run misses it by orders of magnitude (the
last test).  The noise level is a mean over every pixel of the map:
rtol 1e-5.
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gpubench import data, program
from gpubench.counts import joint_var as counts
from gpubench.entries import pick_tiled, process
from gpubench.reference import joint_var as jv
from gpubench.reference import model as ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads: beside five other test workers on the same
    cores, torch's default of one thread a core oversubscribes them, and
    this file ran some 20 times slower than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def config(dtype="f32"):
    with open(os.path.join(ROOT, "gpubench", "configs",
                           "joint_var.json")) as f:
        c = json.load(f)
    c["cfg"]["COMPUTE_DTYPE"] = dtype
    # A denser map, so a small frame holds picks inside its border frame
    # as a 1024^2 one does.
    c["model"]["picks_per_mpx"] = 3000
    return c


def raw_frame(seed, shape):
    mix = {"height": shape[0], "width": shape[1], "pool": 1,
           "particle_density": 5e-4, "particle_sd": 3.0,
           "particle_amp": 4.0, "clip": [-4.0, 6.0]}
    return data.pool(seed, mix)[0]


def build(shape, seed, d):
    """Weights of a seed calibrated on its micrograph (the detector's
    statistics, the sigma net's bias) as set-up does, written as a var
    `.wt` by the port's writer into ``d``, the micrograph as an MRC, and
    a CPU Picker."""
    conf = config()
    model = conf["model"]
    raw = raw_frame(seed, shape)
    img = torch.from_numpy(ref.decode(raw))
    w = jv.make_weights(model, seed, "cpu")
    ref.calibrate(w, model, img, program.sample_noise(shape, seed, "cpu"),
                  conf["cfg"]["NMS"], conf["pick"]["threshold"])
    jv.calibrate_sigma(w, model, img)
    wt = os.path.join(str(d), "var.wt")
    process.write_checkpoint(conf, w, wt, "cpu")
    path = data.write_pool([raw], str(d))[0]
    picker = program.open_picker(conf, wt, seed, "cpu")
    return {"conf": conf, "w": w, "raw": raw, "img": img, "seed": seed,
            "path": path, "picker": picker, "net": jv.Net(w, model, "f32")}


@pytest.fixture(scope="module", params=[((128, 128), 3), ((96, 128), 11)],
                ids=["square", "oblong"])
def case(request, tmp_path_factory):
    shape, seed = request.param
    return build(shape, seed, tmp_path_factory.mktemp("joint_var"))


def test_weights_fill_the_port_exactly(case):
    """Every parameter the reference names has its place in the port's
    var model, and the port holds no other (strict loads)."""
    den = case["picker"].denoiser
    names = set(den.model.state_dict()) | {
        jv.SIGMA + k for k in den.sigma_model.state_dict()}
    assert names == set(case["w"])
    assert "estimated_sigma" not in case["w"]
    assert not den.l_params


def test_sigma_map_matches_the_reference(case):
    den, img = case["picker"].denoiser, case["img"]
    with torch.no_grad():
        got = den.sigma_model(img[None, :, :, None])[0, :, :, 0]
    want = case["net"].sigma_map(img)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_noise_level_matches_the_reference(case):
    """The per-image level: softplus of the map's mean less 4, + 1e-3; the
    seed's bias puts the micrograph it was set on at 4.5413 raw, so the
    level is 1.0 there."""
    from spr_pick_tpu_torch import losses

    den, img = case["picker"].denoiser, case["img"]
    with torch.no_grad():
        raw = den._noise_estimate(img[None, :, :, None])
    assert raw.shape == (1, 1, 1, 1)
    torch.testing.assert_close(raw.reshape(()), torch.tensor(4.5413),
                               rtol=1e-5, atol=0)
    want = case["net"].noise_level(img)
    torch.testing.assert_close(losses.softplus_noise_remap(raw).reshape(()),
                               want, rtol=1e-5, atol=0)
    torch.testing.assert_close(want, torch.tensor(1.0), rtol=1e-3, atol=0)


def test_heatmap_matches_the_reference(case):
    from spr_pick_tpu_torch.params import PipelineOutput
    from spr_pick_tpu_torch.steps import eval_step

    img, seed = case["img"], case["seed"]
    eps = program.sample_noise(img.shape, seed, "cpu")
    out = eval_step(case["picker"].denoiser, {"inp": img[None, :, :, None]},
                    eps=eps[None, :, :, None])
    got = out[PipelineOutput.DETECT][0, :, :, 0]
    torch.testing.assert_close(got, case["net"].heatmap(img, eps),
                               rtol=RTOL, atol=ATOL)


def test_process_table_matches_the_reference(case):
    """One `process_table` request: its denoised image against the var
    posterior mean, its table against greedy NMS of the reference map
    (the Picker's sample noise from its seed) with the border filter."""
    conf, img = case["conf"], case["img"]
    table, den = case["picker"].process_table(case["path"])
    net = case["net"]
    torch.testing.assert_close(torch.from_numpy(den), net.denoised(img),
                               rtol=RTOL, atol=ATOL)
    hm = net.heatmap(img, program.sample_noise(img.shape, case["seed"],
                                               "cpu"))
    p = conf["pick"]
    want = ref.pick_table(*ref.greedy_nms(hm, conf["cfg"]["NMS"],
                                          p["threshold"]),
                          hm.shape, p["border"])
    assert len(want["score"]) > 0
    np.testing.assert_array_equal(table["x_coord"], want["x_coord"])
    np.testing.assert_array_equal(table["y_coord"], want["y_coord"])
    np.testing.assert_allclose(table["score"], want["score"], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("shape,seed", [((128, 128), 3), ((128, 160), 13)],
                         ids=["square", "oblong"])
def test_process_entry_judges_its_own_answer(shape, seed, tmp_path):
    """The entry's judge on the float32 Picker's answer: every exact number
    0, and each gap under one unit of the configuration's bf16 yardstick
    (float32 on both sides).  The frames leave pixels inside the judge's
    margin of border + radius."""
    case = build(shape, seed, tmp_path)
    conf = case["conf"]
    cell = SimpleNamespace(
        config=dict(conf, cfg=dict(conf["cfg"], COMPUTE_DTYPE="bf16")))
    prep = program.Prepared(case["seed"], case["w"], [case["raw"]],
                            [case["path"]], case["picker"])
    answer = process.call(case["picker"], case["path"])
    got = process.judge(cell, prep, 0, answer, "cpu")
    for k in process.EXACT:
        assert got[k] == 0, k
    for k in ("score_vs_bf16", "den_l2_vs_bf16", "den_max_vs_bf16"):
        assert 0 <= got[k] < 1, (k, got[k])


@pytest.mark.parametrize("shape", [(64, 64), (64, 96), (128, 96)])
def test_counts_equal_the_port_convs(shape, monkeypatch):
    """`mic_flops` against 2 cin cout k^2 of every output pixel of every
    conv the port runs in one var forward (fold, detector, sigma net)."""
    from spr_pick_tpu_torch.denoiser import Denoiser
    from spr_pick_tpu_torch.steps import eval_step

    conf = config()
    den = Denoiser(program.port_cfg(conf), mode="joint", device="cpu")
    total = [0]
    real = torch.nn.functional.conv2d

    def counting(x, w, *a, **kw):
        y = real(x, w, *a, **kw)
        total[0] += (2 * w.shape[0] * w.shape[1] * w.shape[2] * w.shape[3]
                     * y.shape[0] * y.shape[2] * y.shape[3])
        return y

    monkeypatch.setattr(torch.nn.functional, "conv2d", counting)
    eval_step(den, {"inp": torch.rand((1,) + shape + (1,))})
    assert total[0] == counts.mic_flops(conf["model"], *shape)
    assert counts.sigma_flops(conf["model"], *shape) > 0


def test_counts_at_the_working_size():
    """The sigma net is 0.578 of the 3.602 TFLOP of a 1024^2 micrograph."""
    model = config()["model"]
    assert counts.sigma_flops(model, 1024, 1024) == 577681489920
    assert counts.mic_flops(model, 1024, 1024) == 3602090364928


@pytest.mark.parametrize("shape,seed", [((128, 160), 5), ((160, 192), 9)],
                         ids=["2x3", "3x3"])
def test_window_reference_equals_the_tiled_route(shape, seed, tmp_path):
    """`pick_tiled.reference_map` against the stitched map of the port's
    halo-tiled route: a Picker whose evaluator tiles frames above 96 px,
    in 64-px tiles with a 16-px halo (96-px windows on the 32-px grid,
    clamped at the frame's edges; 160 px leaves a partial last tile)."""
    conf = config()
    conf["cfg"]["NOISE_VALUE"] = "const"
    model = dict(conf["model"], estimated_sigma_raw=4.5413)
    raw = raw_frame(seed, shape)
    img = torch.from_numpy(ref.decode(raw))
    w = ref.make_weights(model, seed, "cpu")
    ref.calibrate(w, model, img[:96, :96].contiguous(),
                  program.sample_noise((96, 96), seed, "cpu"),
                  conf["cfg"]["NMS"], conf["pick"]["threshold"])
    wt = str(tmp_path / "m.wt")
    conf["model"] = model
    program.write_checkpoint(conf, w, wt, "cpu")
    picker = program.open_picker(conf, wt, seed, "cpu")
    ev = picker.evaluator
    ev.tile_eval_threshold, ev.tile_eval_size, ev.tile_eval_halo = 96, 64, 16
    path = data.write_pool([raw], str(tmp_path))[0]

    from spr_pick_tpu_torch.params import PipelineOutput

    outputs = ev.forward([picker._load(path, False)],
                         torch.Generator().manual_seed(seed))
    got = outputs[PipelineOutput.DETECT][0, :, :, 0]
    want = pick_tiled.reference_map(ref.Net(w, model, "f32"), raw, seed, 64,
                                    16, "cpu")
    assert len(list(pick_tiled.windows(*shape, 64, 16))) == (
        -(-shape[0] // 64)) * (-(-shape[1] // 64))
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_window_plan_refuses_unaligned_windows():
    with pytest.raises(ValueError, match="32-px grid"):
        list(pick_tiled.windows(256, 256, 64, 10))
    with pytest.raises(ValueError, match="inside"):
        list(pick_tiled.windows(64, 256, 64, 16))


@pytest.mark.parametrize("part", ["sigma_map", "denoised"])
def test_bf16_port_fails_the_float32_tolerance(part, tmp_path):
    """The same weights in bf16 (the configuration's dtype) miss the
    float32 tolerance above: the comparison can tell the precisions
    apart."""
    shape, seed = (128, 128), 3
    conf16 = config("bf16")
    model = conf16["model"]
    raw = raw_frame(seed, shape)
    img = torch.from_numpy(ref.decode(raw))
    w = jv.make_weights(model, seed, "cpu")
    jv.calibrate_sigma(w, model, img)
    wt = str(tmp_path / "bf16.wt")
    process.write_checkpoint(conf16, w, wt, "cpu")
    picker = program.open_picker(conf16, wt, seed, "cpu")
    net = jv.Net(w, model, "f32")
    if part == "sigma_map":
        with torch.no_grad():
            got = picker.denoiser.sigma_model(
                img[None, :, :, None])[0, :, :, 0]
        want = net.sigma_map(img)
    else:
        path = data.write_pool([raw], str(tmp_path))[0]
        got = torch.from_numpy(picker.denoise(path))
        want = net.denoised(img)
    assert not torch.allclose(got, want, rtol=RTOL, atol=ATOL)
    assert float((got - want).abs().max()) > 100 * ATOL
