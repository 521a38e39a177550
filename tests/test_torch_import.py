"""The PyTorch port stands alone: it imports nothing of the JAX package
(nor jax, flax or optax, nor the reference package `spr_pick`, whose
checkpoints it reads), runs on the GPU unless asked for the CPU, and
sends CPU tensors to K1's plain version."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from spr_pick_tpu_torch import cfg
from spr_pick_tpu_torch.api import Picker
from spr_pick_tpu_torch.denoiser import Denoiser
from spr_pick_tpu_torch.ops import nms_cuda
from spr_pick_tpu_torch.params import ConfigValue, NoiseAlgorithm, NoiseValue

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "spr_pick_tpu_torch"

_CHILD = r"""
import importlib, pkgutil, sys
import spr_pick_tpu_torch
for m in pkgutil.walk_packages(spr_pick_tpu_torch.__path__, "spr_pick_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(
    k for k in sys.modules
    if k.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "spr_pick_tpu",
                           "spr_pick")
)
mods = sorted(k for k in sys.modules if k.startswith("spr_pick_tpu_torch"))
print("IMPORTED", len(mods))
print("MODULES", " ".join(mods))
print("BAD", bad)
print("LAZY", sorted(k for k in sys.modules
                     if k.split(".")[0] in ("scipy", "h5py")))
from spr_pick_tpu_torch import steps
from spr_pick_tpu_torch.utils.cuda_graph import GraphedSteps
scans = [steps.make_train_scan(None, 0.8, 0.01, 64),
         steps.make_train_scan_sharded(None, 0.8, 0.01, 64, None),
         steps.make_denoise_scan(None, 0.8, 0.01, 64, "n2v", "gauss25"),
         steps.make_denoise_scan_sharded(None, 0.8, 0.01, 64, "n2v",
                                         "gauss25", None)]
GraphedSteps(lambda row: row, [], [])
print("SCANS", sum(callable(f) for f in scans), sorted(
    k for k in sys.modules
    if k.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "spr_pick_tpu",
                           "spr_pick")))
"""


def test_port_imports_no_jax_in_a_fresh_process():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _CHILD], cwd=str(REPO),
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    # scipy and h5py are imported by the functions that use them.
    assert "LAZY []" in out.stdout, out.stdout
    # The K-step chunks and the graph wrapper build without either.
    assert "SCANS 4 []" in out.stdout, out.stdout
    n = int(re.search(r"IMPORTED (\d+)", out.stdout).group(1))
    assert n >= 20  # every submodule was imported
    mods = set(re.search(r"MODULES (.*)", out.stdout).group(1).split())
    assert {"spr_pick_tpu_torch.parallel.tiling", "spr_pick_tpu_torch.eval",
            "spr_pick_tpu_torch.cli.cli", "spr_pick_tpu_torch.__main__",
            "spr_pick_tpu_torch.data.star_export",
            "spr_pick_tpu_torch.utils.image_io",
            "spr_pick_tpu_torch.train", "spr_pick_tpu_torch.steps",
            "spr_pick_tpu_torch.utils.cuda_graph",
            "spr_pick_tpu_torch.data.sampler",
            "spr_pick_tpu_torch.utils.schedule",
            "spr_pick_tpu_torch.utils.tfevents",
            "spr_pick_tpu_torch.utils.profiling",
            "spr_pick_tpu_torch.data.noise", "spr_pick_tpu_torch.data.n2v",
            "spr_pick_tpu_torch.data.noisy", "spr_pick_tpu_torch.data.crop",
            "spr_pick_tpu_torch.data.patches", "spr_pick_tpu_torch.compat",
            "spr_pick_tpu_torch.utils.ref_pickle",
            "spr_pick_tpu_torch.parallel.mesh",
            "spr_pick_tpu_torch.parallel.dcn",
            "spr_pick_tpu_torch.data.hdf5",
            "spr_pick_tpu_torch.data.conversions",
            "spr_pick_tpu_torch.ops.algorithms",
            "spr_pick_tpu_torch.tools.convert_to_star",
            "spr_pick_tpu_torch.tools.generate_train_files",
            "spr_pick_tpu_torch.tools.dataset_tool_h5",
            "spr_pick_tpu_torch.tools.import_reference_checkpoint"} <= mods


_FORBIDDEN = re.compile(
    r"^\s*(?:from|import)\s+(?:spr_pick_tpu(?!_torch)\b|spr_pick\b|jax\b|"
    r"jaxlib\b|flax\b|optax\b)",
    re.MULTILINE,
)


def test_sources_import_nothing_of_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    offenders = [str(f) for f in files if _FORBIDDEN.search(f.read_text())]
    assert offenders == []


def test_picker_defaults_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Picker("missing.wt")


def test_denoiser_defaults_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    c = cfg.base()
    c[ConfigValue.ALGORITHM] = NoiseAlgorithm.SELFSUPERVISED_DENOISING
    c[ConfigValue.NOISE_VALUE] = NoiseValue.UNKNOWN_CONSTANT
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Denoiser(c)
    assert Denoiser(c, device="cpu").device == torch.device("cpu")


def test_trainer_defaults_to_the_gpu(monkeypatch):
    from spr_pick_tpu_torch.train import DenoiserTrainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DenoiserTrainer(None)
    assert DenoiserTrainer(None, device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("algorithm", ["ssdn", "n2v"])
def test_denoise_mode_defaults_to_the_gpu(monkeypatch, algorithm):
    """`Denoiser(cfg, mode="denoise")` and `DenoiserTrainer(cfg,
    mode="denoise")` raise without a card and run with ``device="cpu"``."""
    from spr_pick_tpu_torch.train import DenoiserTrainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    c = cfg.base()
    c[ConfigValue.ALGORITHM] = NoiseAlgorithm(algorithm)
    c[ConfigValue.NOISE_VALUE] = NoiseValue.UNKNOWN_CONSTANT
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Denoiser(c, mode="denoise")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DenoiserTrainer(c, mode="denoise")
    den = Denoiser(c, mode="denoise", device="cpu")
    assert den.device == torch.device("cpu")
    assert den.has_joint_model == (algorithm == "ssdn")
    assert DenoiserTrainer(c, mode="denoise", device="cpu").mode == "denoise"


def test_k1_wrapper_sends_cpu_tensors_to_the_plain_version():
    x = torch.rand(2, 40, 50, generator=torch.Generator().manual_seed(0))
    before = nms_cuda.greedy_nms_cuda.launches
    got = nms_cuda.greedy_nms(x, 4, 0.5, 64)
    want = nms_cuda.greedy_nms_plain(x, 4, 0.5, 64)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert nms_cuda.greedy_nms_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA tensors only"):
        nms_cuda.greedy_nms_cuda(x, 4, 0.5, 64)
    assert nms_cuda.greedy_nms_cuda.launches == before
