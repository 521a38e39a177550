"""The port's tools (`python -m spr_pick_tpu_torch.tools.<name>`) against
the JAX package's root scripts on the same inputs.

Each port tool runs in a subprocess in which importing pandas or PIL fails,
as on a GPU machine without them; each root script runs in a subprocess
with the JAX package.  Outputs must be equal: the same bytes for the
`.star` and the TSV manifests and the same printed lines, the same arrays
(images, shapes, names) in the HDF5 files, which both packages'
`HDF5Dataset` then read alike.  The root `import_reference_checkpoint.py`
needs the reference package itself; its port is held against what that
script does once the package is importable (the JAX package's
`compat.load_reference_checkpoint` and checkpoint writer), with the
stand-in reference package of `tests/test_torch_compat.py`.
"""

import os
import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest

from spr_pick_tpu import compat as jcompat
from spr_pick_tpu.data.hdf5 import HDF5Dataset as JHDF5Dataset
from spr_pick_tpu.utils import checkpoint as jckpt
from spr_pick_tpu_torch.data import files, mrc
from spr_pick_tpu_torch.data.hdf5 import HDF5Dataset
from tests.test_torch_coordinates import picks_table
from tests.test_torch_compat import (FORMS, assert_trees_bit_equal,
                                     comparable, files as ref_files, ref)

REPO = Path(__file__).resolve().parent.parent

_BLOCKED = (
    "import runpy, sys\n"
    "sys.modules['pandas'] = None\n"
    "sys.modules['PIL'] = None\n"
    "name = sys.argv[1]\n"
    "sys.argv = [name] + sys.argv[2:]\n"
    "runpy.run_module('spr_pick_tpu_torch.tools.' + name, "
    "run_name='__main__')\n"
)


def _run(cmd, cwd):
    out = subprocess.run(cmd, cwd=str(cwd),
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def port_tool(name, *args, cwd):
    return _run([sys.executable, "-c", _BLOCKED, name, *map(str, args)], cwd)


def root_tool(script, *args, cwd):
    return _run([sys.executable, str(REPO / script), *map(str, args)], cwd)


def read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def write_scores(d):
    """Two evaluator `_scores.txt` files."""
    d.mkdir()
    table = picks_table(seed=3, n=40)
    for name in ("mic_a", "mic_b"):
        keep = table["image_name"] == name
        files.write_coordinates(str(d / f"{name}_scores.txt"),
                                {k: v[keep] for k, v in table.items()})
    return d


@pytest.mark.parametrize("extra", [[], ["--borders", "100", "3000", "50",
                                        "2500", "--threshold", "0.3"]],
                         ids=["defaults", "borders"])
def test_convert_to_star_matches_root_script(tmp_path, extra):
    scores = write_scores(tmp_path / "scores")
    got = port_tool("convert_to_star", scores, "-o", tmp_path / "p.star",
                    *extra, cwd=tmp_path)
    want = root_tool("convert_to_star.py", scores, "-o", tmp_path / "j.star",
                     *extra, cwd=tmp_path)
    assert got.replace("p.star", "j.star") == want
    assert read_bytes(tmp_path / "p.star") == read_bytes(tmp_path / "j.star")


def micrograph_dir(d, sizes):
    d.mkdir()
    rng = np.random.RandomState(4)
    for i, (h, w) in enumerate(sizes):
        mrc.write(str(d / f"mic_{'abc'[i]}.mrc"),
                  rng.randn(h, w).astype(np.float32))
    (d / "notes.md").write_text("not an image\n")
    return d


@pytest.mark.parametrize("coords", ["star", "box_dir"])
def test_generate_train_files_matches_root_script(tmp_path, coords):
    mics = micrograph_dir(tmp_path / "mics", [(64, 80)] * 2)
    table = picks_table(seed=5, n=30)  # mic_c has no micrograph here
    if coords == "star":
        src = tmp_path / "coords.star"
        files.write_coordinates(str(src), table, format="star",
                                image_ext=".mrc")
    else:
        src = tmp_path / "boxes"
        src.mkdir()
        files.write_coordinates(str(src), table, format="box", boxsize=32)
    got = port_tool("generate_train_files", mics, src, "-o",
                    tmp_path / "port" / "train", "--scale", "4",
                    cwd=tmp_path)
    want = root_tool("generate_train_files.py", mics, src, "-o",
                     tmp_path / "jax" / "train", "--scale", "4",
                     cwd=tmp_path)
    assert "warning: 1 coordinate image(s) have no micrograph" in got
    assert got.replace("port", "jax") == want
    for name in ("train_images.txt", "train_coords.txt"):
        assert read_bytes(tmp_path / "port" / name) == read_bytes(
            tmp_path / "jax" / name), name


def test_dataset_tool_h5_matches_root_script(tmp_path):
    mics = micrograph_dir(tmp_path / "mics", [(48, 64), (64, 40), (32, 32)])
    got = port_tool("dataset_tool_h5", mics, "-o", tmp_path / "p.h5",
                    cwd=tmp_path)
    want = root_tool("tools/dataset_tool_h5.py", mics, "-o",
                     tmp_path / "j.h5", cwd=tmp_path)
    assert got.replace("p.h5", "j.h5") == want
    with h5py.File(tmp_path / "p.h5") as p, h5py.File(tmp_path / "j.h5") as j:
        assert set(p) == set(j) == {"images", "names", "shapes"}
        assert p["images"].compression == j["images"].compression == "gzip"
        for k in ("images", "shapes", "names"):
            assert p[k].dtype == j[k].dtype
            np.testing.assert_array_equal(p[k][()], j[k][()])
    a, b = HDF5Dataset(str(tmp_path / "p.h5")), JHDF5Dataset(
        str(tmp_path / "p.h5"))
    try:
        for i in range(3):
            assert a.image_size(i) == b.image_size(i)
            np.testing.assert_array_equal(a[i], b[i])
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("form", FORMS)
def test_import_reference_checkpoint_matches_jax_conversion(
        ref, ref_files, tmp_path, form):
    ext = ".training" if form == "training" else ".wt"
    out = tmp_path / f"converted{ext}"
    printed = port_tool("import_reference_checkpoint", ref_files[form], "-o",
                        out, "--mode", "joint", cwd=tmp_path)
    ref()  # the stand-in package, for the JAX package's loader
    want = jcompat.load_reference_checkpoint(ref_files[form], mode="joint")
    got = jckpt.load(str(out))
    if form == "training":
        assert printed == (f"converted .training (iteration "
                           f"{want['iteration']}) -> {out}\n")
        assert got["iteration"] == want["iteration"]
    else:
        assert printed == f"converted .wt weights -> {out}\n"
    assert got["mode"] == want["mode"]
    assert comparable(got["cfg"]) == comparable(want["cfg"])
    assert_trees_bit_equal(got["trainable"], want["trainable"])
    assert_trees_bit_equal(got["static"], want["static"])
