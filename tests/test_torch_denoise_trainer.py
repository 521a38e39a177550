"""Denoise-only training: the port's trainer on the CPU against the JAX
package's, on a folder of two 128^2 MRCs with a validation folder and its
clean ground truth.

  * n2v, 4 steps at batch 2 on 32^2 patches, float32, both packages from
    the JAX package's initial weights and on its host data plane
    (``SPR_HOST_DENOISE_DATA=1`` on both sides, so the crops, the
    reference noise and the UPS masks are the same numpy draws): the final
    weights agree within 1e-4 relative L2; both runs lay out the
    same dirs (`training_dn/`, `val_imgs_denoise/` with the nsy/out PNGs of
    every validation, `final-*.wt`) under the same run name, write no
    `_scores.txt`, and log the same validation PSNR (within 0.1%: at
    iteration 8 the two read 2.6272 and 2.6289 dB, the weights' 1e-4
    drift magnified by the output).
  * On the device data plane (the port's default), resuming from the
    middle snapshot ends bit for bit on the uninterrupted run's weights,
    Adam moments and data-plane state (one process, one CPU).
  * The JAX run's `.training` at iteration 4 resumes in the port (weights,
    Adam state, iteration, the host plane's RandomState) and trains to
    the JAX run's final weights within 1e-4; the port's `.training`
    resumes in the JAX trainer with its trees; and each package's
    `final-*.wt` gives `Picker.denoise` equal to the JAX Picker's within
    1e-5.
"""

import contextlib
import os
import shutil

import jax
import numpy as np
import pytest

from spr_pick_tpu import cfg as jcfg_mod
from spr_pick_tpu.api import Picker as JPicker
from spr_pick_tpu.params import ConfigValue as JCV
from spr_pick_tpu.params import NoiseAlgorithm as JNA
from spr_pick_tpu.train import DenoiserTrainer as JTrainer
from spr_pick_tpu.train import resume_run as j_resume_run
from spr_pick_tpu_torch import cfg as cfg_mod
from spr_pick_tpu_torch.api import Picker
from spr_pick_tpu_torch.data import mrc
from spr_pick_tpu_torch.data.patches import (DenoisePatchPipeline,
                                             DeviceDenoisePipeline)
from spr_pick_tpu_torch.params import ConfigValue, NoiseAlgorithm
from spr_pick_tpu_torch.train import DenoiserTrainer, resume_run
from spr_pick_tpu_torch.utils import checkpoint as ckpt
from tests.test_torch_trainer import assert_trees_equal, leaves

RUN = "00000-train-n2v-gauss25-iter8-0.8-0.01-denoise"
FINAL = "final-n2v-gauss25-iter8-0.8-0.01-denoise.wt"
REL_L2 = 1e-4


def make_folders(tmp):
    """train/ (two 128^2 MRCs), val/ (one) and gt/ (its clean image) under
    ``tmp``; returns their paths and the validation micrograph's."""
    rng = np.random.RandomState(0)
    out = {}
    for d in ("train", "val", "gt"):
        out[d] = str(tmp / d)
        os.makedirs(out[d])
    for i in range(2):
        clean = rng.rand(128, 128).astype(np.float32)
        mrc.write(os.path.join(out["train"], f"m{i}.mrc"),
                  clean + 0.1 * rng.randn(128, 128).astype(np.float32))
    clean = rng.rand(128, 128).astype(np.float32)
    out["mic"] = os.path.join(out["val"], "v0.mrc")
    mrc.write(out["mic"], clean + 0.1 * rng.randn(128, 128).astype(np.float32))
    mrc.write(os.path.join(out["gt"], "v0.mrc"), clean)
    return out


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    return make_folders(tmp_path_factory.mktemp("denoise_folders"))


def make_cfg(jax=False):
    cv, na = (JCV, JNA) if jax else (ConfigValue, NoiseAlgorithm)
    c = (jcfg_mod if jax else cfg_mod).base()
    c[cv.ALGORITHM] = na.NOISE_TO_VOID
    c[cv.NOISE_STYLE] = "gauss25"
    c[cv.COMPUTE_DTYPE] = "f32"
    c[cv.ITERATIONS] = 8
    c[cv.TRAIN_MINIBATCH_SIZE] = 2
    c[cv.TRAIN_PATCH_SIZE] = 32
    for key in (cv.EVAL_INTERVAL, cv.PRINT_INTERVAL, cv.SNAPSHOT_INTERVAL):
        c[key] = 4
    return c


def set_data(t, folders):
    t.set_train_data(folders["train"])
    t.set_test_data(folders["val"])
    t.set_test_gt_data(folders["gt"])
    return t


@contextlib.contextmanager
def host_plane():
    old = os.environ.get("SPR_HOST_DENOISE_DATA")
    os.environ["SPR_HOST_DENOISE_DATA"] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ["SPR_HOST_DENOISE_DATA"]
        else:
            os.environ["SPR_HOST_DENOISE_DATA"] = old


def port_trainer(folders, runs_dir):
    return set_data(DenoiserTrainer(make_cfg(), mode="denoise", alpha=0.8,
                                    tau=0.01, runs_dir=str(runs_dir),
                                    device="cpu"), folders)


@pytest.fixture(scope="module")
def runs(folders, tmp_path_factory):
    """Both packages' n2v run on the host plane from the JAX initial
    weights."""
    with host_plane():
        j = set_data(JTrainer(make_cfg(jax=True), mode="denoise", alpha=0.8,
                              tau=0.01,
                              runs_dir=str(tmp_path_factory.mktemp("jax"))),
                     folders)
        j.new_target()
        init = [jax.tree_util.tree_map(np.asarray, tree) for tree in
                (j.train_state.trainable, j.train_state.static)]
        j.train()
        t = port_trainer(folders, tmp_path_factory.mktemp("port"))
        t.new_target()
        t.denoiser.load_variables(*init)
        t.train()
    return j, t


def assert_trees_close(got, want):
    """Relative L2 over all leaves.  Leaf by leaf it would not hold: the
    biases start at zero, so after four Adam steps a leaf is a few
    lr-sized updates, and one element whose tiny gradient rounds to the
    other sign moves its update by 2 lr."""
    got, want = dict(leaves(got)), dict(leaves(want))
    assert got.keys() == want.keys()
    num = sum(float(np.sum((got[k] - w) ** 2)) for k, w in want.items())
    den = sum(float(np.sum(w ** 2)) for w in want.values())
    assert (num / den) ** 0.5 <= REL_L2


def test_n2v_run_matches_jax(runs):
    j, t = runs
    assert isinstance(t.patch_pipeline, DenoisePatchPipeline)
    assert t.train_sampler is None and t.iteration == j.iteration == 8
    assert_trees_close(t.denoiser.variables()[0],
                       jax.tree_util.tree_map(np.asarray,
                                              j.train_state.trainable))


def psnr_rows(run):
    rows = [r for r in cfg_rows(run) if r["tag"] == "valid/psnr_out"]
    return [(r["step"], r["value"]) for r in rows]


def cfg_rows(run):
    import json

    with open(os.path.join(run, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_run_dirs_images_and_psnr_like_jax(runs):
    j, t = runs
    jrun, run = j.run_dir_path, t.run_dir_path
    assert os.path.basename(run) == os.path.basename(jrun) == RUN
    for sub in ("training_dn", "val_imgs_denoise"):
        assert sorted(os.listdir(os.path.join(run, sub))) == \
            sorted(os.listdir(os.path.join(jrun, sub))), sub
    assert sorted(os.listdir(os.path.join(run, "training_dn"))) == [
        f"model_{i:08d}.training" for i in (0, 4, 8)]
    val = sorted(os.listdir(os.path.join(run, "val_imgs_denoise")))
    assert val == sorted(f"v0_{i:08d}_{d}.png" for i in (0, 4, 8)
                         for d in ("nsy", "out"))
    assert os.path.isfile(os.path.join(run, FINAL))
    assert not [f for _, _, fs in os.walk(run) for f in fs
                if f.endswith("_scores.txt")]
    got, want = psnr_rows(run), psnr_rows(jrun)
    assert [s for s, _ in got] == [s for s, _ in want] == [0, 4, 8]
    for (_, g), (_, w) in zip(got, want):
        assert np.isfinite(g) and abs(g - w) <= 1e-3 * abs(w)


def test_resume_from_the_middle_is_bit_exact(folders, tmp_path):
    """The device data plane: its generator state rides in the snapshot."""
    a = port_trainer(folders, tmp_path / "a")
    a.train()
    assert isinstance(a.patch_pipeline, DeviceDenoisePipeline)
    copy = str(tmp_path / "b" / RUN)
    shutil.copytree(a.run_dir_path, copy)
    b = resume_run(copy, iteration=4, device="cpu")
    assert b.mode == "denoise" and b.iteration == 4
    b.train()
    sa, sb = (ckpt.load(os.path.join(r, "training_dn",
                                     "model_00000008.training"))
              for r in (a.run_dir_path, copy))
    for key in ("trainable", "static"):
        assert_trees_equal(sa[key], sb[key])
    for x, y in zip(sa["opt_state"][1:], sb["opt_state"][1:]):
        assert_trees_equal(x, y)
    pa, pb = (s["extra"]["data_state"]["pipeline"] for s in (sa, sb))
    assert pa["key_counter"] == pb["key_counter"] == 4
    np.testing.assert_array_equal(pa["torch_generator"]["state"],
                                  pb["torch_generator"]["state"])


def test_jax_written_training_resumes_in_the_port(runs, tmp_path):
    j, _ = runs
    copy = str(tmp_path / RUN)
    shutil.copytree(j.run_dir_path, copy)
    shutil.rmtree(os.path.join(copy, "val_imgs_denoise"))
    state = ckpt.load(os.path.join(copy, "training_dn",
                                   "model_00000004.training"))
    with host_plane():
        t = resume_run(copy, device="cpu", iteration=4)
        assert t.mode == "denoise" and t.iteration == 4
        assert t.train_state.step == 2 and t.train_state.opt.count == 2
        assert_trees_equal(t.denoiser.variables()[0], state["trainable"])
        t.train()
    assert_trees_close(t.denoiser.variables()[0],
                       jax.tree_util.tree_map(np.asarray,
                                              j.train_state.trainable))


def test_port_written_training_resumes_in_jax(runs):
    _, t = runs
    j = j_resume_run(t.run_dir_path, iteration=4)
    state = ckpt.load(os.path.join(t.run_dir_path, "training_dn",
                                   "model_00000004.training"))
    assert j.mode == "denoise" and j.iteration == 4
    assert int(j.train_state.opt_state.count) == 2
    assert_trees_equal(jax.tree_util.tree_map(np.asarray,
                                              j.train_state.trainable),
                       state["trainable"])
    assert "rng_state" in j._pending_data_state["pipeline"]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_final_wt_denoises_like_the_jax_picker(runs, folders, writer):
    j, t = runs
    wt = os.path.join((t if writer == "port" else j).run_dir_path, FINAL)
    got = Picker(wt, device="cpu").denoise(folders["mic"])
    want = JPicker(wt).denoise(folders["mic"])
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))
