"""`train start` and `train resume` as commands, and the JAX package
reading what they write.

The port's command trains on the CPU only when asked (``--device cpu``);
without the flag and without a GPU both subcommands raise,
``--dn_only`` on an HDF5 dataset starts a run, and
``--mesh 2`` with one card exits naming both counts.  A
run started by the command (bf16 compute, the default, batch 4, 8
iterations, a snapshot at 4) is resumed by the command from its snapshot
at 4 and must end on the same weights, bit for bit (one process, one CPU).
The command also runs as ``python -m spr_pick_tpu_torch`` in a
subprocess, with ``--profile`` writing a trace of its first print window.
The run's `final-*.wt` is then read by the JAX package: its
`Picker` and the port's pick the same sets on the same micrograph
(float32, the A half zeroed so z == mu and the classifier scaled as in
`tests/test_torch_api.py`, written back with the port's writer; scores
within 1e-5), and its cfg comes back keyed by the JAX package's enums.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from spr_pick_tpu.api import Picker as JPicker
from spr_pick_tpu.utils import checkpoint as jckpt
from spr_pick_tpu_torch.api import Picker
from spr_pick_tpu_torch.cli import cli
from spr_pick_tpu_torch.data import mrc
from spr_pick_tpu_torch.params import ConfigValue
from spr_pick_tpu_torch.utils import checkpoint as ckpt
from tests.test_e2e import make_synthetic_dataset
from tests.test_torch_api import assert_same_picks

REPO = Path(__file__).resolve().parent.parent
RUN = "00000-train-ssdn-gauss-iter8-0.8-0.01-joint"


def start_args(dataset, runs_dir, *extra):
    images, coords = dataset
    return ["train", "start", "-a", "ssdn", "-n", "gauss", "--noise_value",
            "const", "-t", images, "-l", coords, "--alpha", "0.8", "--tau",
            "0.01", "--iterations", "8", "--train_batch_size", "4",
            "--checkpoint_interval", "4", "--print_interval", "4",
            "--eval_interval", "1000", "--runs_dir", str(runs_dir), *extra]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli_train")
    return make_synthetic_dataset(tmp, np.random.RandomState(1), n_images=2,
                                  size=256, n_particles=4)


@pytest.fixture(scope="module")
def run(dataset, tmp_path_factory):
    runs = tmp_path_factory.mktemp("runs")
    cli.start(start_args(dataset, runs, "--device", "cpu"))
    return runs / RUN


def test_start_writes_the_jax_layout(run):
    assert sorted(os.listdir(run / "training_jt")) == [
        "model_00000000.training", "model_00000004.training",
        "model_00000008.training"]
    assert (run / "final-ssdn-gauss-iter8-0.8-0.01-joint.wt").is_file()
    state = ckpt.load(str(run / "training_jt" / "model_00000008.training"))
    assert state["cfg"][ConfigValue.COMPUTE_DTYPE] == "bf16"
    assert state["cfg"][ConfigValue.TRAIN_MINIBATCH_SIZE] == 4
    assert "loss" in (run / "log.txt").read_text()


def test_resume_command_ends_on_the_same_weights(run, tmp_path):
    import shutil

    copy = tmp_path / RUN
    shutil.copytree(run, copy)
    cli.start(["train", "resume", str(copy), "--iteration", "4",
               "--device", "cpu"])
    a = ckpt.load(str(run / "training_jt" / "model_00000008.training"))
    b = ckpt.load(str(copy / "training_jt" / "model_00000008.training"))
    from tests.test_torch_trainer import assert_trees_equal

    assert_trees_equal(a["trainable"], b["trainable"])
    assert_trees_equal(a["static"], b["static"])
    assert_trees_equal(a["opt_state"][1], b["opt_state"][1])


def test_without_a_gpu_both_commands_raise(dataset, run, tmp_path,
                                           monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.start(start_args(dataset, tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.start(["train", "resume", str(run)])
    assert not (tmp_path / RUN).exists()


def test_dn_only_on_hdf5_starts_a_run(dataset, tmp_path):
    """``--dn_only -t train.h5``: ssdn trains on the HDF5 file's images
    (`tests/test_torch_hdf5.py` holds the route against the JAX package)."""
    import h5py

    h5 = str(tmp_path / "train.h5")
    with h5py.File(h5, "w") as f:
        f.create_dataset("images", data=np.random.RandomState(2).rand(
            2, 96, 96).astype(np.float32))
    runs = tmp_path / "runs"
    cli.start(start_args(dataset, runs, "--device", "cpu", "--dn_only",
                         "-t", h5))
    run = runs / "00000-train-ssdn-gauss-iter8-0.8-0.01-denoise"
    assert (run / "final-ssdn-gauss-iter8-0.8-0.01-denoise.wt").is_file()
    assert sorted(os.listdir(run / "training_dn")) == [
        f"model_{i:08d}.training" for i in (0, 4, 8)]


@pytest.mark.parametrize("extra,match", [
    (["--mesh", "2"], "--mesh 2: 2 GPUs are needed, 1 visible"),
])
def test_refusals(dataset, tmp_path, monkeypatch, extra, match):
    """``--mesh 2`` on a host with one card exits naming both counts
    (``--mesh 2 --device cpu`` trains on two gloo ranks:
    `tests/test_torch_ddp.py`)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match=match):
        cli.start(start_args(dataset, tmp_path, *extra))
    assert not (tmp_path / RUN).exists()


def test_module_entry_point(dataset, tmp_path):
    """``python -m spr_pick_tpu_torch train start --profile``: the run, and
    the torch.profiler trace of its first print window."""
    args = start_args(dataset, tmp_path, "--device", "cpu", "--profile")
    args[args.index("--iterations") + 1] = "4"
    out = subprocess.run(
        [sys.executable, "-m", "spr_pick_tpu_torch", *args], cwd=str(REPO),
        env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True,
        text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    run = tmp_path / "00000-train-ssdn-gauss-iter4-0.8-0.01-joint"
    assert (run / "final-ssdn-gauss-iter4-0.8-0.01-joint.wt").is_file()
    assert "TRAINING FINISHED" in out.stderr
    assert (run / "profile" / "trace.json").stat().st_size > 0


def test_jax_picker_reads_the_port_trained_wt(run, tmp_path):
    state = ckpt.load(str(run / "final-ssdn-gauss-iter8-0.8-0.01-joint.wt"))
    head = state["trainable"]["model"]["denoise_branch"]["out_conv"]["conv"]
    head["kernel"][..., 1] = 0.0
    head["bias"][1] = 0.0
    state["trainable"]["model"]["detector"]["classifier"]["classifier"][
        "kernel"] *= 20
    state["cfg"][ConfigValue.COMPUTE_DTYPE] = "f32"
    wt = str(tmp_path / "f32.wt")
    ckpt.save_weights(wt, state["trainable"], state["static"], state["cfg"],
                      state["mode"])
    from spr_pick_tpu.params import ConfigValue as JCV

    jstate = jckpt.load(wt)
    assert jstate["cfg"][JCV.COMPUTE_DTYPE] == "f32"
    img = str(tmp_path / "mic.mrc")
    mrc.write(img, (np.random.RandomState(2).randn(128, 128) * 3 + 10)
              .astype(np.float32))
    want = JPicker(wt, border=0).pick(img)
    got = Picker(wt, border=0, device="cpu").pick(img)
    assert_same_picks(got, want)
