"""HDF5 datasets in the PyTorch port against the JAX package.

  * `HDF5Dataset` reads uint8 and float32 files, with and without
    ``shapes``, exactly as the JAX package's does (length, names, pixels,
    sizes).
  * Denoise-only training on an `.h5` under ``SPR_HOST_DENOISE_DATA=1``:
    the first batches are the JAX package's, bit for bit.
  * ``train start --dn_only -t x.h5 -v x.h5 -vgt GT`` runs on the CPU, and
    ``eval -d x.h5 -gt GT`` of its `final-*.wt` logs the PSNR the JAX
    evaluator logs on the same weights in float32 within 1e-4 dB (conv
    accumulation order).
  * Joint training on an `.h5` is refused (coordinates need a TXT
    manifest), as in the JAX package; without h5py opening one raises the
    ImportError that names it.  (`tests/test_torch_eval.py` holds an
    evaluator's `test_data()` on an `.h5` against the JAX package's.)
"""

import os
import sys

import h5py
import numpy as np
import pytest

from spr_pick_tpu.data.hdf5 import HDF5Dataset as JHDF5Dataset
from spr_pick_tpu.eval import DenoiserEvaluator as JEvaluator
from spr_pick_tpu.params import HistoryValue, StateValue
from spr_pick_tpu.train import DenoiserTrainer as JTrainer
from spr_pick_tpu_torch.cli import cli
from spr_pick_tpu_torch.data import mrc
from spr_pick_tpu_torch.data.hdf5 import HDF5Dataset
from spr_pick_tpu_torch.data.patches import DenoisePatchPipeline
from spr_pick_tpu_torch.eval import DenoiserEvaluator
from spr_pick_tpu_torch.params import ConfigValue
from spr_pick_tpu_torch.train import DenoiserTrainer
from spr_pick_tpu_torch.utils import checkpoint as ckpt
from tests.test_torch_denoise_trainer import host_plane, make_cfg

SHAPES = [(64, 64), (48, 60), (64, 56)]
PSNR_ATOL = 1e-4  # dB


def write_h5(path, dtype, with_shapes, seed=0):
    """Images stored the way `HDF5Dataset` reads them: each flattened into
    the start of a (max H, max W) slot, its (H, W) in ``shapes``."""
    rng = np.random.RandomState(seed)
    shapes = SHAPES if with_shapes else [SHAPES[0]] * len(SHAPES)
    slot = np.zeros((len(shapes), 64, 64), dtype)
    for i, (h, w) in enumerate(shapes):
        img = rng.rand(h, w)
        img = (img * 255).astype(dtype) if dtype == np.uint8 else img
        slot[i].reshape(-1)[: h * w] = img.astype(dtype).reshape(-1)
    with h5py.File(path, "w") as f:
        f.create_dataset("images", data=slot)
        if with_shapes:
            f.create_dataset("shapes", data=np.asarray(shapes, np.int32))
    return str(path)


@pytest.mark.parametrize("with_shapes", [True, False],
                         ids=["shapes", "no-shapes"])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32],
                         ids=["uint8", "float32"])
def test_hdf5_dataset_matches_jax(tmp_path, dtype, with_shapes):
    path = write_h5(tmp_path / "x.h5", dtype, with_shapes)
    got, want = HDF5Dataset(path), JHDF5Dataset(path)
    try:
        assert len(got) == len(want) == 3
        for i in range(3):
            assert got.name(i) == want.name(i) == f"{i:06d}"
            assert got.image_size(i) == want.image_size(i)
            a, b = got[i], want[i]
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        assert got.image_size(1) == (SHAPES[1] if with_shapes else SHAPES[0])
        assert float(got[0].max()) <= 1.0
    finally:
        got.close()
        want.close()


@pytest.fixture(scope="module")
def h5_set(tmp_path_factory):
    """x.h5 (three float32 64^2 images) and gt/ (their clean MRCs)."""
    tmp = tmp_path_factory.mktemp("h5")
    rng = np.random.RandomState(1)
    clean = rng.rand(3, 64, 64).astype(np.float32)
    noisy = np.clip(clean + 0.1 * rng.randn(3, 64, 64), 0, 1).astype(
        np.float32)
    path = str(tmp / "x.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("images", data=noisy)
    os.makedirs(tmp / "gt")
    for i in range(3):
        mrc.write(str(tmp / "gt" / f"g{i}.mrc"), clean[i])
    return {"h5": path, "gt": str(tmp / "gt"), "tmp": tmp}


def test_first_host_batches_are_the_jax_batches(h5_set, tmp_path):
    with host_plane():
        t = DenoiserTrainer(make_cfg(), mode="denoise", alpha=0.8, tau=0.01,
                            runs_dir=str(tmp_path / "p"), device="cpu")
        t.set_train_data(h5_set["h5"])
        j = JTrainer(make_cfg(jax=True), mode="denoise", alpha=0.8, tau=0.01,
                     runs_dir=str(tmp_path / "j"))
        j.set_train_data(h5_set["h5"])
        base, sampler, pipe = t.train_data()
        jbase, _, jpipe = j.train_data()
    assert isinstance(base, HDF5Dataset) and sampler is None
    assert isinstance(pipe, DenoisePatchPipeline)
    for _ in range(2):
        got, want = pipe.batch(2), jpipe.batch(2)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_joint_training_on_hdf5_is_refused(h5_set, tmp_path):
    c = make_cfg()
    t = DenoiserTrainer(c, mode="joint", alpha=0.8, tau=0.01,
                        runs_dir=str(tmp_path), device="cpu")
    t.set_train_data(h5_set["h5"])
    with pytest.raises(NotImplementedError, match="TXT manifest"):
        t.train_data()


def eval_psnr(history):
    return float(np.mean(history["psnr_out"].accumulated()))


def test_train_and_eval_commands_on_hdf5(h5_set, tmp_path):
    runs = tmp_path / "runs"
    cli.start(["train", "start", "--dn_only", "-a", "n2v", "-n", "gauss25",
               "-t", h5_set["h5"], "-l", "none", "--alpha", "0.8", "--tau",
               "0.01", "--iterations", "4", "--train_batch_size", "2",
               "--patch_size", "32", "--checkpoint_interval", "4",
               "--print_interval", "4", "--eval_interval", "4", "-v",
               h5_set["h5"], "-vgt", h5_set["gt"], "--runs_dir", str(runs),
               "--device", "cpu"])
    (run,) = os.listdir(runs)
    final = runs / run / "final-n2v-gauss25-iter4-0.8-0.01-denoise.wt"
    assert final.is_file()
    val = sorted(os.listdir(runs / run / "val_imgs_denoise"))
    assert "000000_00000004_out.png" in val

    cli.start(["eval", "-m", str(final), "-d", h5_set["h5"], "-gt",
               h5_set["gt"], "--runs_dir", str(tmp_path / "ev"),
               "--device", "cpu"])
    (ev,) = os.listdir(tmp_path / "ev")
    imgs = sorted(os.listdir(tmp_path / "ev" / ev / "eval_imgs"))
    assert imgs == ["000000_nsy.png", "000000_out.png"]

    # The command trained in bf16, where XLA and oneDNN round apart; the
    # packages are compared on the same weights in float32.
    state = ckpt.load(str(final))
    state["cfg"][ConfigValue.COMPUTE_DTYPE] = "f32"
    f32 = str(tmp_path / "f32.wt")
    ckpt.save_weights(f32, state["trainable"], state["static"], state["cfg"],
                      state["mode"])
    port = DenoiserEvaluator(f32, runs_dir=str(tmp_path / "pe"),
                             mode="denoise", device="cpu")
    port.set_test_data(h5_set["h5"])
    port.set_test_gt_data(h5_set["gt"])
    port.evaluate()
    jev = JEvaluator(f32, runs_dir=str(tmp_path / "je"),
                     mode="denoise")
    jev.set_test_data(h5_set["h5"])
    jev.set_test_gt_data(h5_set["gt"])
    jev.evaluate()
    got = eval_psnr(port.eval_history)
    want = eval_psnr(jev.state[StateValue.HISTORY][HistoryValue.EVAL])
    assert np.isfinite(got) and abs(got - want) <= PSNR_ATOL


def test_without_h5py_opening_a_dataset_names_it(h5_set, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py is required"):
        HDF5Dataset(h5_set["h5"])
