"""Denoise-only training and evaluation as commands.

``python -m spr_pick_tpu_torch train start --dn_only -a n2v ... --device
cpu`` on a folder of micrographs with a validation folder and its ground
truth, then ``train resume`` of a copy from its middle snapshot, each in a
subprocess: both lay out `training_dn/` and the `final-*.wt`, and the
resumed run ends on the uninterrupted run's weights, bit for bit (CPU).
``eval -m final.wt -d DIR -gt DIR`` writes the nsy/out PNGs and the PSNR,
and no `_scores.txt`.  ``--noise_input`` reaches the cfg of a
``--dn_only`` run.  Without ``--device`` and with no card, `train start
--dn_only` and `eval` raise "no CUDA device".
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from spr_pick_tpu_torch.cli import cli
from spr_pick_tpu_torch.params import ConfigValue
from spr_pick_tpu_torch.utils import checkpoint as ckpt
from tests.test_torch_denoise_trainer import FINAL, RUN, make_folders
from tests.test_torch_trainer import assert_trees_equal

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    return make_folders(tmp_path_factory.mktemp("denoise_folders"))


def start_args(folders, runs_dir, *extra):
    return ["train", "start", "--dn_only", "-a", "n2v", "-n", "gauss25",
            "-t", folders["train"], "-l", "none", "--alpha", "0.8", "--tau",
            "0.01", "--iterations", "8", "--train_batch_size", "2",
            "--patch_size", "32", "--checkpoint_interval", "4",
            "--print_interval", "4", "--eval_interval", "4", "-v",
            folders["val"], "-vgt", folders["gt"], "--runs_dir",
            str(runs_dir), *extra]


def module(*args):
    out = subprocess.run(
        [sys.executable, "-m", "spr_pick_tpu_torch", *args], cwd=str(REPO),
        env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True,
        text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    return out


@pytest.fixture(scope="module")
def run(folders, tmp_path_factory):
    runs = tmp_path_factory.mktemp("dn_runs")
    out = module(*start_args(folders, runs, "--device", "cpu"))
    assert "TRAINING FINISHED" in out.stderr
    return runs / RUN


def test_start_and_resume_commands(run, tmp_path):
    assert sorted(os.listdir(run / "training_dn")) == [
        "model_00000000.training", "model_00000004.training",
        "model_00000008.training"]
    assert (run / FINAL).is_file()
    assert len(os.listdir(run / "val_imgs_denoise")) == 6
    copy = tmp_path / RUN
    shutil.copytree(run, copy)
    module("train", "resume", str(copy), "--iteration", "4", "--device",
           "cpu")
    a, b = (ckpt.load(str(r / "training_dn" / "model_00000008.training"))
            for r in (run, copy))
    assert a["mode"] == b["mode"] == "denoise"
    for key in ("trainable", "static"):
        assert_trees_equal(a[key], b[key])
    assert_trees_equal(a["opt_state"][1], b["opt_state"][1])


def test_eval_command_writes_images_and_psnr(run, folders, tmp_path):
    cli.start(["eval", "-m", str(run / FINAL), "-d", folders["val"], "-gt",
               folders["gt"], "--runs_dir", str(tmp_path), "--device", "cpu"])
    (ev,) = os.listdir(tmp_path)
    assert ev.startswith("00000-eval-n2v-gauss25-")
    files = sorted(os.listdir(tmp_path / ev / "eval_imgs"))
    assert files == ["v0_nsy.png", "v0_out.png"]
    assert "psnr_out" in (tmp_path / ev / "log.txt").read_text()


def test_noise_input_reaches_the_cfg(folders, tmp_path):
    args = start_args(folders, tmp_path, "--device", "cpu", "--noise_input")
    args[args.index("--iterations") + 1] = "2"
    cli.start(args)
    (name,) = os.listdir(tmp_path)
    state = ckpt.load(str(tmp_path / name / "training_dn"
                          / "model_00000002.training"))
    assert state["cfg"][ConfigValue.NOISE_INPUT] is True
    rows = [json.loads(line) for line in
            open(tmp_path / name / "scalars.jsonl")]
    assert all(np.isfinite(r["value"]) for r in rows)


def test_without_a_gpu_the_commands_raise(folders, run, tmp_path,
                                          monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.start(start_args(folders, tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.start(["eval", "-m", str(run / FINAL), "-d", folders["val"],
                   "--runs_dir", str(tmp_path)])
    assert not os.listdir(tmp_path)
