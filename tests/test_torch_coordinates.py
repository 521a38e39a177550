"""The PyTorch port's coordinate writers, conversions, pick-quality metrics
and small library leftovers against the JAX package on the same seeded
inputs.

- `write_coordinates`: every format gives the bytes the JAX package's
  pandas writer gives (TSV and star floats included: `data/table.py` prints
  the shortest round-trip text, as `to_csv` does);
- conversions, `match_coordinates`, `precision_recall_f1` and
  `dtype_to_mode`/`make_header`/`write`: equal.
"""

import json
import os

import numpy as np
import pandas as pd
import pytest

from spr_pick_tpu.data import conversions as jconv
from spr_pick_tpu.data import files as jfiles
from spr_pick_tpu.data import mrc as jmrc
from spr_pick_tpu.ops import algorithms as jalg
from spr_pick_tpu_torch.data import conversions, files
from spr_pick_tpu_torch.data import mrc
from spr_pick_tpu_torch.data import table as tbl
from spr_pick_tpu_torch.ops import algorithms


def picks_table(seed=0, n=23, score=True):
    rng = np.random.RandomState(seed)
    names = np.array(["mic_b", "mic_a", "mic_c"], dtype=object)
    table = {
        "image_name": names[rng.randint(0, 3, n)],
        "x_coord": rng.randint(0, 1000, n).astype(np.int64),
        "y_coord": rng.randint(0, 800, n).astype(np.int64),
    }
    if score:
        table["score"] = rng.rand(n).astype(np.float32)
    return table


def read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("fmt,score", [
    ("coord", True), ("coord", False), ("star", True), ("csv", True),
    ("csv", False),
])
def test_single_file_writers_match_jax_bytes(tmp_path, fmt, score):
    table = picks_table(score=score)
    got, want = tmp_path / "port.out", tmp_path / "jax.out"
    files.write_coordinates(str(got), table, format=fmt, image_ext=".tiff")
    jfiles.write_coordinates(str(want), pd.DataFrame(table), format=fmt,
                             image_ext=".tiff")
    assert read_bytes(got) == read_bytes(want)


@pytest.mark.parametrize("fmt", ["box", "json"])
def test_per_image_writers_match_jax_bytes(tmp_path, fmt):
    table = picks_table(seed=1)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    files.write_coordinates(str(tmp_path / "port"), table, format=fmt,
                            boxsize=40, suffix="_p")
    jfiles.write_coordinates(str(tmp_path / "jax"), pd.DataFrame(table),
                             format=fmt, boxsize=40, suffix="_p")
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert len(names) == 3
    for name in names:
        assert read_bytes(tmp_path / "port" / name) == read_bytes(
            tmp_path / "jax" / name)


@pytest.mark.parametrize("fmt,ext", [("coord", ".txt"), ("star", ".star"),
                                     ("csv", ".csv"), ("box", ".box")])
def test_written_files_read_back(tmp_path, fmt, ext):
    """`read_coordinates` of what `write_coordinates` wrote: the same rows
    (box files hold the box corner, read back as its centre)."""
    table = picks_table(seed=2)
    if fmt == "box":
        files.write_coordinates(str(tmp_path), table, format="box",
                                boxsize=20)
        back = tbl.concat([files.read_coordinates(str(tmp_path / f"{n}.box"))
                           for n in ("mic_a", "mic_b", "mic_c")])
        order = np.argsort(np.asarray(table["image_name"]).astype(str),
                           kind="stable")
        table = tbl.select(table, order)
    else:
        path = str(tmp_path / f"picks{ext}")
        files.write_coordinates(path, table, format=fmt, image_ext=".mrc")
        back = files.read_coordinates(path)
    for k in ("image_name", "x_coord", "y_coord"):
        np.testing.assert_array_equal(np.asarray(back[k]).astype(str),
                                      np.asarray(table[k]).astype(str))
    if fmt != "box":
        np.testing.assert_array_equal(back["score"].astype(np.float32),
                                      table["score"])


def test_conversions_match_jax():
    rng = np.random.RandomState(3)
    boxes = np.concatenate([rng.randint(0, 500, (9, 2)),
                            rng.randint(8, 40, (9, 2))], axis=1)
    for invert in (False, True):
        np.testing.assert_array_equal(
            conversions.boxes_to_coordinates(boxes, (600, 700), invert),
            jconv.boxes_to_coordinates(boxes, (600, 700), invert))
    got = conversions.boxes_to_coordinates(boxes, image_name="m")
    want = jconv.boxes_to_coordinates(boxes, image_name="m")
    assert list(got) == list(want.columns)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k].to_numpy())
    for name in (None, "m"):
        empty = conversions.boxes_to_coordinates(np.zeros((0, 4), int),
                                                 image_name=name)
        jempty = jconv.boxes_to_coordinates(np.zeros((0, 4), int),
                                            image_name=name)
        assert list(empty) == list(jempty.columns)
        assert tbl.num_rows(empty) == 0

    xy = rng.randint(0, 500, (11, 2))
    for invert in (False, True):
        np.testing.assert_array_equal(
            conversions.coordinates_to_boxes(xy, 32, 24, (512, 512), invert),
            jconv.coordinates_to_boxes(xy, 32, 24, (512, 512), invert))
        assert conversions.coordinates_to_eman2_json(
            xy, (512, 512), invert, tag="auto") == \
            jconv.coordinates_to_eman2_json(xy, (512, 512), invert,
                                            tag="auto")

    table = dict(picks_table(seed=4), voltage=np.full(23, 300.0))
    got = conversions.coordinates_to_star(table, image_ext=".mrc")
    want = jconv.coordinates_to_star(pd.DataFrame(table), image_ext=".mrc")
    assert list(got) == list(want.columns)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k].to_numpy())


MATCH_CASES = {
    "empty preds": (np.zeros((0, 2)), np.array([[1.0, 2.0]])),
    "empty targets": (np.array([[1.0, 2.0], [5.0, 5.0]]), np.zeros((0, 2))),
    # Two predictions at the same distance from one target.
    "ties": (np.array([[10.0, 10.0], [10.0, 16.0], [50.0, 50.0]]),
             np.array([[10.0, 13.0], [80.0, 80.0]])),
    # Exactly at the radius (cost 0: no match) and just inside it.
    "radius edge": (np.array([[0.0, 15.0], [100.0, 114.9], [200.0, 200.0]]),
                    np.array([[0.0, 0.0], [100.0, 100.0], [230.0, 200.0]])),
}


@pytest.mark.parametrize("case", sorted(MATCH_CASES))
def test_match_coordinates_matches_jax(case):
    preds, targets = MATCH_CASES[case]
    got = algorithms.match_coordinates(targets, preds, 15)
    want = jalg.match_coordinates(targets, preds, 15)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert algorithms.precision_recall_f1(targets, preds, 15) == \
        jalg.precision_recall_f1(targets, preds, 15)


@pytest.mark.parametrize("radius", [5, 10, 15])
def test_match_coordinates_on_seeded_sets_matches_jax(radius):
    rng = np.random.RandomState(5)
    targets = rng.randint(0, 512, (60, 2)).astype(float)
    preds = targets[rng.permutation(60)[:45]] + rng.randn(45, 2) * 6
    preds = np.concatenate([preds, rng.randint(0, 512, (15, 2))])
    got = algorithms.match_coordinates(targets, preds, radius)
    want = jalg.match_coordinates(targets, preds, radius)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert algorithms.precision_recall_f1(targets, preds, radius) == \
        jalg.precision_recall_f1(targets, preds, radius)


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.float32, np.uint16,
                                   np.complex64])
def test_mrc_header_and_write_match_jax(dtype, tmp_path):
    assert mrc.dtype_to_mode(dtype) == jmrc.dtype_to_mode(dtype)
    with pytest.raises(ValueError):
        mrc.dtype_to_mode(np.float64)
    kw = dict(cella=(2.0, 3.0, 4.0), mz=3, dtype=dtype, dmin=-1.5,
              dmax=9.0, dmean=1.25, rms=0.5, exthd_size=12, ispg=1)
    assert mrc.make_header((3, 40, 50), **kw).tobytes() == \
        jmrc.make_header((3, 40, 50), **kw).tobytes()
    x = np.random.RandomState(7).randn(33, 47).astype(np.float32)
    mrc.write(str(tmp_path / "p.mrc"), x, extended_header=b"x" * 8, ax=1.5)
    jmrc.write(str(tmp_path / "j.mrc"), x, extended_header=b"x" * 8, ax=1.5)
    assert read_bytes(tmp_path / "p.mrc") == read_bytes(tmp_path / "j.mrc")


def test_json_writer_reads_as_eman2_boxes(tmp_path):
    table = picks_table(seed=11, n=5, score=False)
    files.write_coordinates(str(tmp_path), table, format="json")
    for name in set(table["image_name"]):
        with open(tmp_path / f"{name}_info.json") as f:
            boxes = json.load(f)["boxes"]
        keep = table["image_name"] == name
        assert boxes == [[int(x), int(y), "manual"] for x, y in zip(
            table["x_coord"][keep], table["y_coord"][keep])]
