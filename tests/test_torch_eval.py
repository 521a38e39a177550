"""The `eval` command: the port against the JAX package.

Both packages' `eval` commands run on the same inputs with the same flags:
the JAX-written float32 checkpoint of `tests/test_torch_api.py` (A half
zeroed, so z == mu), two 96x128 MRCs in a TXT manifest with coordinate
labels and a ground-truth manifest, and ``--export_star``:

  * "batched": ``--batch_size 2``, one forward and one batched NMS call for
    both micrographs;
  * "contam": ``--exclude_contam --batch_size 2``, NMS seeded with
    `find_contamination` masks (one micrograph holds a dark blob);
  * "folder": a directory of the MRCs, no labels, one micrograph a forward.
  * "pipelined": ``--batch_size 1`` with the JAX evaluator's one-group
    export deferral (``SPR_EVAL_PIPELINE=1``) against the port's one loop.

Compared: the run dir's name, the file names in `eval_imgs/`, the
`_scores.txt` tables (same rows; scores within 1e-5), the `.star` files
parsed (same rows; scores within 1e-5), PSNR against the ground truth
within 1e-4, and the decoded PNG pixels: equal for the maps made on the
host (input, target heatmap), and within one 8-bit level for the model's
maps, whose float32 values differ between the packages by ~1e-6 and can
cross a truncation boundary.  Beside the runs: the device u8 quantise
against the host bytes, the PNG writer, the coordinate readers (.star,
.box, VIA .csv, .txt) against JAX's, and the items of an HDF5 test set
against JAX's.
"""

import csv
import os

import numpy as np
import pytest
import torch
from PIL import Image

from spr_pick_tpu.cli import cli as jax_cli
from spr_pick_tpu.eval import DenoiserEvaluator as JEvaluator
from spr_pick_tpu.params import HistoryValue, NoiseValue, StateValue
from spr_pick_tpu_torch.cli import cli as port_cli
from spr_pick_tpu_torch.data import mrc
from spr_pick_tpu_torch.eval import DenoiserEvaluator
from spr_pick_tpu_torch.utils.image_io import (quantize_u8_device, to_u8,
                                               write_png)
from tests.test_torch_api import ATOL, make_jax_wt

RUNS = {
    "batched": ["--batch_size", "2"],
    "contam": ["--exclude_contam", "--batch_size", "2"],
    "folder": [],
    # The JAX evaluator with its export deferral (SPR_EVAL_PIPELINE=1), one
    # micrograph a group so the first group's export runs after the second
    # forward; the port has the one, undeferred loop.
    "pipelined": ["--batch_size", "1"],
}
HOST_MAPS = ("nsy", "out-target")


def write_dataset(d):
    rng = np.random.RandomState(0)
    (d / "mics").mkdir()
    (d / "gts").mkdir()
    rows, gt_rows = [], []
    for i in range(2):
        clean = rng.rand(96, 128).astype(np.float32)
        noisy = clean + 0.3 * rng.randn(96, 128).astype(np.float32)
        if i == 0:
            yy, xx = np.mgrid[:96, :128]
            noisy[(yy - 40) ** 2 + (xx - 70) ** 2 < 100] -= 4.0  # contamination
        mrc.write(str(d / "mics" / f"m{i}.mrc"), noisy)
        mrc.write(str(d / "gts" / f"m{i}.mrc"), clean)
        rows.append(f"m{i}\t{d / 'mics' / f'm{i}.mrc'}")
        gt_rows.append(f"m{i}\t{d / 'gts' / f'm{i}.mrc'}")
    (d / "imgs.txt").write_text("image_name\tpath\n" + "\n".join(rows) + "\n")
    (d / "gt.txt").write_text("image_name\tpath\n" + "\n".join(gt_rows) + "\n")
    (d / "coords.txt").write_text(
        "image_name\tx_coord\ty_coord\n"
        "m0\t40\t50\nm0\t100\t30\nm1\t60\t70\nm1\t20\t20\n"
    )


def _run(start, evaluator_cls, argv):
    """Run one `eval` command; return the evaluator it built."""
    made = []
    evaluate = evaluator_cls.evaluate

    def recording(self):
        made.append(self)
        return evaluate(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(evaluator_cls, "evaluate", recording)
        start(argv)
    return made[0]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("eval")
    wt = make_jax_wt(str(d / "const.wt"), NoiseValue.UNKNOWN_CONSTANT)
    write_dataset(d)
    out = {}
    for name, extra in RUNS.items():
        if name == "folder":
            data = ["-d", str(d / "mics")]
        else:
            data = ["-d", str(d / "imgs.txt"), "-l", str(d / "coords.txt"),
                    "-gt", str(d / "gt.txt")]
        argv = ["eval", "-m", wt, *data, "--num", "2", "--export_star", *extra]
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("SPR_EVAL_PIPELINE", "1" if name == "pipelined" else "0")
            jev = _run(jax_cli.start, JEvaluator,
                       argv + ["--runs_dir", str(d / name / "jax")])
        pev = _run(port_cli.start, DenoiserEvaluator,
                   argv + ["--runs_dir", str(d / name / "port"),
                           "--device", "cpu"])
        jax_psnr = {
            k: float(np.mean(m.accumulated()))
            for k, m in jev.state[StateValue.HISTORY][HistoryValue.EVAL].items()
            if k != "n" and not m.empty()
        }
        port_psnr = {k: float(np.mean(m.accumulated()))
                     for k, m in pev.eval_history.items()
                     if k != "n" and not m.empty()}
        out[name] = dict(jax=jev.run_dir_path, port=pev.run_dir_path,
                         jax_psnr=jax_psnr, port_psnr=port_psnr, wt=wt,
                         mics=d / "mics")
    return out


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f, delimiter="\t"))


def _same_table(got, want, score_col):
    assert len(got) == len(want) > 1  # a header and at least one pick
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        assert g[:score_col] == w[:score_col]
        assert abs(float(g[score_col]) - float(w[score_col])) <= ATOL


@pytest.mark.parametrize("run", list(RUNS))
def test_eval_artifact_names_match_jax(runs, run):
    r = runs[run]
    assert os.path.basename(r["port"]) == os.path.basename(r["jax"])
    got = sorted(os.listdir(os.path.join(r["port"], "eval_imgs")))
    want = sorted(os.listdir(os.path.join(r["jax"], "eval_imgs")))
    assert got == want
    assert len(got) == (14 if run != "folder" else 12)


@pytest.mark.parametrize("run", list(RUNS))
def test_eval_scores_match_jax(runs, run):
    r = runs[run]
    for name in ("m0", "m1"):
        f = os.path.join("eval_imgs", f"{name}_scores.txt")
        _same_table(_rows(os.path.join(r["port"], f)),
                    _rows(os.path.join(r["jax"], f)), score_col=3)


@pytest.mark.parametrize("run", list(RUNS))
def test_eval_star_matches_jax(runs, run):
    r = runs[run]
    got = _rows(os.path.join(r["port"], "particles.star"))
    want = _rows(os.path.join(r["jax"], "particles.star"))
    assert got[:6] == want[:6]  # data_images, loop_, the four columns
    _same_table(got[5:], want[5:], score_col=3)


@pytest.mark.parametrize("run", list(RUNS))
def test_eval_png_pixels_match_jax(runs, run):
    r = runs[run]
    d = os.path.join(r["jax"], "eval_imgs")
    for f in sorted(os.listdir(d)):
        if not f.endswith(".png"):
            continue
        with Image.open(os.path.join(d, f)) as im:
            want = np.asarray(im).astype(int)
        with Image.open(os.path.join(r["port"], "eval_imgs", f)) as im:
            assert im.mode == "L"
            got = np.asarray(im).astype(int)
        assert got.shape == want.shape == (96, 128)
        if f[:-4].split("_", 1)[1] in HOST_MAPS:
            np.testing.assert_array_equal(got, want, err_msg=f)
        else:
            assert np.abs(got - want).max() <= 1, f


@pytest.mark.parametrize("run,batch_size", [("batched", 2), ("folder", 1)])
def test_eval_scores_are_the_pickers_rows(runs, run, batch_size):
    """The port's `_scores.txt` rows are `Picker.pick_many_table`'s (30 px
    border) on the same MRCs, groups and checkpoint, text for text: the
    evaluator decodes on the host, the Picker quantises on the device, and
    both run the one inference loop and write the one picks table."""
    from spr_pick_tpu_torch.api import Picker

    r = runs[run]
    picker = Picker(r["wt"], device="cpu")
    table = picker.pick_many_table(
        [str(r["mics"] / f"m{i}.mrc") for i in range(2)],
        batch_size=batch_size)
    got = [list(table)] + [[str(v) for v in row]
                           for row in zip(*table.values())]
    want = [got[0]]
    for name in ("m0", "m1"):
        rows = _rows(os.path.join(r["port"], "eval_imgs",
                                  f"{name}_scores.txt"))
        assert rows[0] == want[0] and len(rows) > 1
        want += rows[1:]
    assert got == want


def test_eval_contamination_seeding_moves_picks(runs):
    """--exclude_contam changes m0's picks (the blob is excluded) in both
    packages alike."""
    f = os.path.join("eval_imgs", "m0_scores.txt")
    for side in ("jax", "port"):
        assert (_rows(os.path.join(runs["contam"][side], f))
                != _rows(os.path.join(runs["batched"][side], f)))


@pytest.mark.parametrize("run", ["batched", "contam", "pipelined"])
def test_eval_psnr_matches_jax(runs, run):
    r = runs[run]
    assert sorted(r["port_psnr"]) == sorted(r["jax_psnr"]) == [
        "psnr_mu_out", "psnr_out"]
    for k, v in r["jax_psnr"].items():
        assert abs(r["port_psnr"][k] - v) <= 1e-4


@pytest.mark.parametrize("case", ["random", "constant", "pad", "negative"])
def test_quantize_u8_device_is_the_host_bytes(case):
    rng = np.random.RandomState(7)
    arr = rng.randn(1, 64, 96, 1).astype(np.float32)
    shape = (64, 96)
    if case == "constant":
        arr[:] = 0.25
    elif case == "pad":
        arr[:, 50:, 80:] = 100.0  # only the pad holds the extremes
        shape = (50, 80)
    elif case == "negative":
        arr = -np.abs(arr) * 1e-3
    got = quantize_u8_device(torch.from_numpy(arr), shape).numpy()
    want = to_u8(arr[0, : shape[0], : shape[1], 0])
    np.testing.assert_array_equal(got, want)


def test_write_png_decodes_to_its_pixels(tmp_path):
    u8 = np.random.RandomState(8).randint(0, 256, (37, 53)).astype(np.uint8)
    write_png(u8, str(tmp_path / "a.png"))
    with Image.open(tmp_path / "a.png") as im:
        assert im.mode == "L" and im.size == (53, 37)
        np.testing.assert_array_equal(np.asarray(im), u8)


def test_hdf5_eval_dataset_yields_the_jax_images(tmp_path):
    """`test_data()` on an `.h5`: the JAX package's items, name by name."""
    import h5py

    from spr_pick_tpu.eval import DenoiserEvaluator as JEvaluator
    from tests.test_torch_api_tiled import make_port_wt

    h5 = str(tmp_path / "mics.h5")
    with h5py.File(h5, "w") as f:
        f.create_dataset("images", data=np.random.RandomState(3).randint(
            0, 256, (2, 40, 52)).astype(np.uint8))
    wt = make_port_wt(str(tmp_path / "w.wt"))
    ev = DenoiserEvaluator(wt, runs_dir=str(tmp_path / "runs"), device="cpu")
    ev.set_test_data(h5)
    jev = JEvaluator(wt, runs_dir=str(tmp_path / "jruns"))
    jev.set_test_data(h5)
    (data, _), (jdata, _) = ev.test_data(), jev.test_data()
    assert len(data) == len(jdata) == 2
    for i in range(2):
        got = data.test_item(i, pad_multiple=32, square=False)
        want = jdata.test_item(i, pad_multiple=32, square=False)
        assert got["name"] == want["name"]
        assert got["image_shape"] == want["image_shape"] == (40, 52)
        np.testing.assert_array_equal(got["inp"], np.asarray(want["inp"]))


COORDINATE_FILES = {
    "star": ("data_images\nloop_\n_rlnMicrographName #1\n"
             "_rlnCoordinateX #2\n_rlnCoordinateY #3\n"
             "_rlnParticleScore #4\n"
             "m0.mrc\t12.0\t34.7\t0.5\nm1.mrc\t56\t78\t0.25\n"),
    "box": "10\t20\t16\t16\n30\t40\t16\t16\n",
    "csv": ("filename,file_size,file_attributes,region_count,region_id,"
            "region_shape_attributes,region_attributes\n"
            'm0.png,-1,{},2,0,"{""name"":""point"",""cx"":5,""cy"":6}",'
            '"{""score"":""0.5""}"\n'
            'm0.png,-1,{},2,1,"{""name"":""point"",""cx"":7,""cy"":8}",'
            '"{""score"":""0.75""}"\n'
            'm1.png,-1,{},0,0,"{}","{}"\n'),
    "txt": "image_name\tx_coord\ty_coord\nm0\t1\t2\nm1\t3\t4\n",
}


@pytest.mark.parametrize("fmt", list(COORDINATE_FILES))
def test_read_coordinates_matches_jax(tmp_path, fmt):
    from spr_pick_tpu.data.files import read_coordinates as jax_read
    from spr_pick_tpu_torch.data.files import read_coordinates

    path = tmp_path / f"m0.{fmt}"
    path.write_text(COORDINATE_FILES[fmt])
    got = read_coordinates(str(path))
    want = jax_read(str(path))
    assert sorted(got) == sorted(want.columns)
    for col in want.columns:
        w = want[col].to_numpy()
        if w.dtype.kind in "if":
            np.testing.assert_allclose(got[col].astype(float),
                                       w.astype(float), err_msg=col)
        else:
            assert [str(v) for v in got[col]] == [str(v) for v in w], col
