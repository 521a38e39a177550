"""The `pick` command: the port against the JAX package, and both commands
without pandas or PIL.

Both packages' `pick` commands run with the same arguments on the JAX-written
float32 checkpoint of `tests/test_torch_api.py` (A half zeroed, so z == mu)
and three 96x128 MRCs, two in one directory and one in another under a name
the first already holds (so it becomes ``mic0-2``):

  * "dirs-tsv": the two directories to a TSV;
  * "manifest-star": a TSV manifest (image_name, path) to a RELION .star;
  * "dirs-stdout": the two directories to TSV on standard output;
  * "denoise-mrc" / "denoise-png": ``--denoise_dir`` in each format, picks
    and denoised images from one forward.

Tables are compared parsed: the same rows, scores within 1e-5.  Denoised
MRCs must agree within 1e-5 and denoised PNGs within one 8-bit level
(float32 values that differ by ~1e-6 can cross a truncation boundary).

The last test runs the port's `pick` and `eval` in a fresh interpreter in
which importing pandas or PIL fails, as on a GPU machine without them.
"""

import contextlib
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from spr_pick_tpu.cli import cli as jax_cli
from spr_pick_tpu.params import NoiseValue
from spr_pick_tpu_torch.cli import cli as port_cli
from spr_pick_tpu_torch.data import mrc
from tests.test_torch_api import ATOL, make_jax_wt

REPO = Path(__file__).resolve().parent.parent

RUNS = ["dirs-tsv", "manifest-star", "dirs-stdout", "denoise-mrc",
        "denoise-png"]


def _argv(d, run, out):
    if run == "manifest-star":
        return [str(d / "imgs.txt"), "-o", str(out / "picks.star")]
    args = [str(d / "a"), str(d / "b")]
    if run == "dirs-stdout":
        return args + ["-o", "-"]
    args += ["-o", str(out / "picks.txt")]
    if run.startswith("denoise"):
        args += ["--denoise_dir", str(out / "den"),
                 "--denoise_format", run.split("-")[1]]
    return args


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("pick")
    wt = make_jax_wt(str(d / "const.wt"), NoiseValue.UNKNOWN_CONSTANT)
    rng = np.random.RandomState(0)
    (d / "a").mkdir()
    (d / "b").mkdir()
    paths = [d / "a" / "mic0.mrc", d / "a" / "mic1.mrc", d / "b" / "mic0.mrc"]
    for p in paths:
        mrc.write(str(p), (rng.randn(96, 128) * 3 + 10).astype(np.float32))
    (d / "imgs.txt").write_text(
        "image_name\tpath\n"
        + "".join(f"n{i}\t{p}\n" for i, p in enumerate(paths)))
    return d, wt


@pytest.fixture(scope="module")
def runs(data):
    d, wt = data
    out = {}
    for run in RUNS:
        out[run] = {}
        for side, start, extra in (("jax", jax_cli.start, []),
                                   ("port", port_cli.start,
                                    ["--device", "cpu"])):
            where = d / run / side
            where.mkdir(parents=True)
            stdout = io.StringIO()
            with contextlib.redirect_stdout(stdout):
                start(["pick", "-m", wt, *_argv(d, run, where), *extra])
            out[run][side] = (where, stdout.getvalue())
    return out


def _parse(text):
    return [line.split("\t") for line in text.strip().splitlines()]


def _same_rows(got, want):
    assert len(got) == len(want) > 1
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        assert g[:-1] == w[:-1]
        assert abs(float(g[-1]) - float(w[-1])) <= ATOL


@pytest.mark.parametrize("run", RUNS)
def test_pick_table_matches_jax(runs, run):
    (jdir, jout), (pdir, pout) = runs[run]["jax"], runs[run]["port"]
    if run == "dirs-stdout":
        got, want = _parse(pout), _parse(jout)
    else:
        name = "picks.star" if run == "manifest-star" else "picks.txt"
        got = _parse((pdir / name).read_text())
        want = _parse((jdir / name).read_text())
    if run == "manifest-star":
        assert got[:6] == want[:6]  # data_images, loop_, the four columns
        got, want = got[5:], want[5:]
    _same_rows(got, want)
    names = {row[0] for row in got[1:] if len(row) == 4}
    if run == "manifest-star":
        assert names == {"n0", "n1", "n2"}
    else:
        assert names == {"mic0", "mic1", "mic0-2"}


@pytest.mark.parametrize("run", ["denoise-mrc", "denoise-png"])
def test_pick_denoise_dir_matches_jax(runs, run):
    (jdir, _), (pdir, _) = runs[run]["jax"], runs[run]["port"]
    files = sorted(os.listdir(jdir / "den"))
    assert sorted(os.listdir(pdir / "den")) == files
    ext = run.split("-")[1]
    assert files == [f"mic0-2.{ext}", f"mic0.{ext}", f"mic1.{ext}"]
    for f in files:
        if ext == "mrc":
            got = mrc.read(str(pdir / "den" / f))[0]
            want = mrc.read(str(jdir / "den" / f))[0]
            assert got.shape == want.shape == (96, 128)
            np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
        else:
            with Image.open(pdir / "den" / f) as g, \
                    Image.open(jdir / "den" / f) as w:
                got, want = (np.asarray(g).astype(int),
                             np.asarray(w).astype(int))
            assert got.shape == want.shape == (96, 128)
            assert np.abs(got - want).max() <= 1


def test_denoise_dir_picks_equal_pick_many(runs):
    """One forward per micrograph (process) gives the batched picks."""
    got = _parse((runs["denoise-mrc"]["port"][0] / "picks.txt").read_text())
    want = _parse((runs["dirs-tsv"]["port"][0] / "picks.txt").read_text())
    _same_rows(got, want)


def test_expand_pick_inputs_errors(tmp_path):
    bad = tmp_path / "bad.txt"
    bad.write_text("image_name\tnot_path\na\tb\n")
    with pytest.raises(SystemExit, match="no 'path' column"):
        port_cli._expand_pick_inputs([str(bad)])
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(SystemExit, match="no images found"):
        port_cli._expand_pick_inputs([str(empty)])


def test_expand_pick_inputs_dedups_like_jax(tmp_path):
    img = np.zeros((8, 8), np.float32)
    dirs = []
    for d in ("a", "b", "c"):
        (tmp_path / d).mkdir()
        mrc.write(str(tmp_path / d / "mic1.mrc"), img)
        dirs.append(str(tmp_path / d))
    mrc.write(str(tmp_path / "a" / "other.mrc"), img)
    got = port_cli._expand_pick_inputs(dirs)
    assert got == jax_cli._expand_pick_inputs(dirs)
    assert sorted(got[1]) == ["mic1", "mic1-2", "mic1-3", "other"]


def test_train_is_refused():
    """Joint and denoise-only training are ported
    (tests/test_torch_cli_train.py, tests/test_torch_cli_denoise.py);
    `train` still refuses ``--noise_input`` without ``--dn_only``, as the
    JAX command does, and a command line without its required flags."""
    with pytest.raises(SystemExit, match="only applies to denoise-only"):
        port_cli.start(["train", "start", "-a", "ssdn", "-n", "gauss",
                        "--noise_value", "const", "-t", "imgs.txt", "-l",
                        "coords.txt", "--alpha", "0.8", "--tau", "0.01",
                        "--iterations", "8", "--noise_input", "--device",
                        "cpu"])
    with pytest.raises(SystemExit):
        port_cli.start(["train", "start", "-a", "ssdn"])


_BLOCKED = (
    "import runpy, sys\n"
    "sys.modules['pandas'] = None\n"
    "sys.modules['PIL'] = None\n"
    "sys.argv = ['spr_pick_tpu_torch'] + sys.argv[1:]\n"
    "runpy.run_module('spr_pick_tpu_torch', run_name='__main__')\n"
)


def test_commands_run_without_pandas_or_pil(data, runs, tmp_path):
    d, wt = data
    env = dict(os.environ, PYTHONPATH=str(REPO))

    def run(*args):
        out = subprocess.run(
            [sys.executable, "-c", _BLOCKED, *args, "--device", "cpu"],
            cwd=str(tmp_path), env=env, capture_output=True, text=True,
            timeout=300,
        )
        assert out.returncode == 0, out.stderr[-2000:]

    run("pick", "-m", wt, str(d / "a"), str(d / "b"), "-o",
        str(tmp_path / "p.star"), "--denoise_dir", str(tmp_path / "den"),
        "--denoise_format", "png")
    want = runs["denoise-png"]["port"][0]
    assert sorted(os.listdir(tmp_path / "den")) == sorted(
        os.listdir(want / "den"))
    run("pick", "-m", wt, str(d / "a"), str(d / "b"), "-o",
        str(tmp_path / "p.txt"))
    _same_rows(_parse((tmp_path / "p.txt").read_text()),
               _parse((runs["dirs-tsv"]["port"][0] / "picks.txt").read_text()))
    run("eval", "-m", wt, "-d", str(d / "imgs.txt"), "--num", "3",
        "--runs_dir", str(tmp_path / "runs"), "--export_star")
    (run_dir,) = os.listdir(tmp_path / "runs")
    imgs = sorted(os.listdir(tmp_path / "runs" / run_dir / "eval_imgs"))
    assert len(imgs) == 3 * 7 and "n2_scores.txt" in imgs
    assert (tmp_path / "runs" / run_dir / "particles.star").exists()
