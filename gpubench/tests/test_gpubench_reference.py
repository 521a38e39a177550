"""The frozen plain reference against the port, on the CPU, at a tiny size
in float32: the dense pick map, the denoised image, greedy NMS and the
MRC decode."""

import json
import os

import numpy as np
import pytest
import torch

from gpubench import data, program
from gpubench.program import sample_noise
from gpubench.reference import model as ref

HERE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def config(name, dtype="f32"):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        c = json.load(f)
    c["cfg"]["COMPUTE_DTYPE"] = dtype
    return c


def port_denoiser(conf, weights, tmp_path):
    from spr_pick_tpu_torch.eval import DenoiserEvaluator

    wt = os.path.join(str(tmp_path), "m.wt")
    program.write_checkpoint(conf, weights, wt, "cpu")
    return DenoiserEvaluator(wt, mode=conf["mode"], device="cpu").denoiser


@pytest.mark.parametrize("seed,shape", [(0, (64, 64)), (7, (64, 64)),
                                        (3, (64, 96))])
def test_pick_map_matches_the_port(seed, shape, tmp_path):
    """The dense pick map, with the detector's statistics set from the
    seed's network (as a run sets them), on square and oblong frames."""
    from spr_pick_tpu_torch.params import PipelineOutput
    from spr_pick_tpu_torch.steps import eval_step

    conf = config("joint_r8")
    w = ref.make_weights(conf["model"], seed, "cpu")
    img = torch.from_numpy(ref.decode(
        np.random.default_rng(seed).standard_normal(shape)))
    eps = sample_noise(shape, seed, "cpu")
    ref.calibrate(w, conf["model"], img, eps, 15, 0.02)
    den = port_denoiser(conf, w, tmp_path)
    out = eval_step(den, {"inp": img[None, :, :, None]},
                    eps=eps[None, :, :, None])
    got = out[PipelineOutput.DETECT][0, :, :, 0]
    want = ref.Net(w, conf["model"]).heatmap(img, eps)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_denoised_matches_the_port(tmp_path):
    from spr_pick_tpu_torch.params import PipelineOutput
    from spr_pick_tpu_torch.steps import eval_step

    conf = config("dn_ssdn")
    w = ref.make_weights(conf["model"], 5, "cpu")
    den = port_denoiser(conf, w, tmp_path)
    img = torch.from_numpy(ref.decode(
        np.random.default_rng(5).standard_normal((64, 64))))
    out = eval_step(den, {"inp": img[None, :, :, None]})
    got = out[PipelineOutput.IMG_DENOISED][0, :, :, 0]
    want = ref.Net(w, conf["model"]).denoised(img)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_greedy_nms_matches_the_port():
    from spr_pick_tpu_torch.ops.nms import non_maximum_suppression_np

    rng = np.random.default_rng(1)
    hm = rng.random((70, 90)).astype(np.float32)
    hm[10, 10] = hm[10, 12] = 0.999          # a tie: the later index first
    scores, rows, cols = ref.greedy_nms(torch.from_numpy(hm), 5, 0.3)
    want_s, want_xy = non_maximum_suppression_np(hm, 5, 0.3)
    np.testing.assert_array_equal(scores, want_s)
    np.testing.assert_array_equal(cols, want_xy[:, 0])
    np.testing.assert_array_equal(rows, want_xy[:, 1])


def test_decode_matches_the_port_reader(tmp_path):
    from spr_pick_tpu_torch.data.loader import load_image

    mix = {"height": 96, "width": 112, "pool": 1, "particle_density": 5e-4,
           "particle_sd": 2.0, "particle_amp": 4.0, "clip": [-4.0, 6.0]}
    raw = data.pool(3, mix)[0]
    path = data.write_pool([raw], str(tmp_path))[0]
    np.testing.assert_array_equal(load_image(path), ref.decode(raw))


def test_pool_decodes_at_one_contrast():
    """Every micrograph of a pool reaches both ends of the mix's clip
    range, so each one decodes at the same contrast."""
    mix = {"height": 256, "width": 256, "pool": 3, "particle_density": 5e-5,
           "particle_sd": 6.0, "particle_amp": 4.0, "clip": [-4.0, 6.0]}
    for raw in data.pool(2 ** 31 + 3, mix):
        assert (float(raw.min()), float(raw.max())) == (-4.0, 6.0)
