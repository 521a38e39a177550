"""The MRC min-max quantise on the Picker's device
(`data/loader.py:minmax_quantize_device`) against the host decode
(`minmax_quantize_u8(x).astype(np.float32) / 255.0` and the JAX package's
`load_mrc`), bit for bit; `mrc.parse` and `mrc.read` against the JAX
package's reader in every mode; and the Picker's MRC path calls, which
quantise on the device, against the same micrographs passed in as arrays,
with the counter ``load.device_quantise``.

The tests marked ``cuda`` run the quantise on the card.  They import
nothing of JAX or of the JAX package, so they run where neither is
installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_device_quantise.py -q
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from spr_pick_tpu_torch import cfg as cfg_mod
from spr_pick_tpu_torch.api import Picker
from spr_pick_tpu_torch.data import mrc
from spr_pick_tpu_torch.data.loader import (load_image,
                                           minmax_quantize_device,
                                           minmax_quantize_u8)
from spr_pick_tpu_torch.data.micrograph import pad_to_multiple
from spr_pick_tpu_torch.denoiser import Denoiser
from spr_pick_tpu_torch.params import ConfigValue as CV
from spr_pick_tpu_torch.params import NoiseAlgorithm, NoiseValue
from spr_pick_tpu_torch.utils import checkpoint as ckpt
from spr_pick_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNTER = "load.device_quantise"

# (scale, offset) of seeded Gaussian micrographs: ranges from 1e-20 to
# 1e20, with offsets large against the range.
RANGES = [(1.0, 0.0), (1e-20, 0.0), (1e-20, 3e-17), (1e-3, 1e2),
          (1.0, 1e4), (1e5, 0.0), (1e20, 0.0), (1e20, -7e23)]


def host(x: np.ndarray) -> np.ndarray:
    return minmax_quantize_u8(x).astype(np.float32) / 255.0


def bits(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)


def on_device(stack: np.ndarray, device="cpu") -> np.ndarray:
    x = torch.from_numpy(np.ascontiguousarray(stack, dtype=np.float32))
    return minmax_quantize_device(x.to(device)).cpu().numpy()


def write_mrc(path: str, array: np.ndarray) -> str:
    """A one-section MRC in ``array``'s dtype (float32 or int16)."""
    header = mrc.make_header((1,) + array.shape, dtype=array.dtype)
    with open(path, "wb") as f:
        f.write(np.asarray(header, dtype=mrc.HEADER_DTYPE).tobytes())
        f.write(np.ascontiguousarray(array).tobytes())
    return path


def three_ranges() -> np.ndarray:
    """A batch of 3 micrographs, each at its own range (per-micrograph
    ``lo`` and ``hi``)."""
    rng = np.random.default_rng(3)
    return np.stack([
        rng.standard_normal((48, 56)) * 1e-3 + 5.0,
        rng.standard_normal((48, 56)) * 1e3,
        -1e6 - np.abs(rng.standard_normal((48, 56))) * 7.0,
    ]).astype(np.float32)


def assert_decodes_as_host(path: str) -> None:
    """The device quantise of the file's raw values equals the port's host
    decode and the JAX package's `load_mrc`, bit for bit."""
    from spr_pick_tpu.data.loader import load_mrc as jax_load_mrc

    raw = np.asarray(mrc.read(path)[0], dtype=np.float32)
    got = on_device(raw[None])[0]
    np.testing.assert_array_equal(bits(got), bits(host(raw)))
    np.testing.assert_array_equal(bits(got), bits(jax_load_mrc(path)))
    np.testing.assert_array_equal(bits(got), bits(load_image(path)))


@pytest.mark.parametrize("scale,offset", RANGES)
def test_gaussians_at_every_range(tmp_path, scale, offset):
    for seed in range(4):
        rng = np.random.default_rng(seed)
        x = (rng.standard_normal((40, 52)) * scale + offset).astype(
            np.float32)
        assert_decodes_as_host(write_mrc(str(tmp_path / f"{seed}.mrc"), x))


@pytest.mark.parametrize("case", ["constant", "negative", "int16"])
def test_edge_micrographs(tmp_path, case):
    rng = np.random.default_rng(7)
    x = {
        "constant": lambda: np.full((33, 31), -2.5, np.float32),
        "negative": lambda: (-3.0 - np.abs(rng.standard_normal((33, 31)))
                             ).astype(np.float32),
        "int16": lambda: rng.integers(-3000, 3000, (33, 31)).astype(np.int16),
    }[case]()
    path = write_mrc(str(tmp_path / "m.mrc"), x)
    assert mrc.read(path)[0].dtype == x.dtype
    assert_decodes_as_host(path)
    if case == "constant":
        assert not on_device(x[None].astype(np.float32)).any()


def test_batch_of_three_scales_each_micrograph():
    x = three_ranges()
    got = on_device(x)
    for i in range(3):
        np.testing.assert_array_equal(bits(got[i]), bits(host(x[i])))
        assert got[i].min() == 0.0 and got[i].max() == 1.0


def test_padding_before_the_quantise_changes_no_bit():
    """The Picker pads the raw frame, then quantises on the device; the
    host path quantises, then pads.  A 1000x1000 frame takes the
    reflection pad to 1024x1024."""
    raw = np.random.default_rng(11).standard_normal((1000, 1000)).astype(
        np.float32) * 40 + 3
    padded, shape = pad_to_multiple(raw, 32, square=True)
    assert padded.shape == (1024, 1024) and shape == (1000, 1000)
    want, _ = pad_to_multiple(host(raw), 32, square=True)
    np.testing.assert_array_equal(bits(on_device(padded[None])[0]),
                                  bits(want))


def mrc_bytes(mode: int, ext: int) -> bytes:
    """A (2, 3, 5) map of ``mode`` with ``ext`` bytes of extended header."""
    n = 2 * 3 * 5
    header = np.zeros((), dtype=mrc.HEADER_DTYPE)
    header["nx"], header["ny"], header["nz"], header["mode"] = 5, 3, 2, mode
    header["next"] = ext
    item = {0: 1, 1: 2, 2: 4, 3: 4, 4: 8, 6: 2, 16: 3}[mode]
    payload = (np.arange(n * item) * 37 % 251).astype(np.uint8).tobytes()
    return header.tobytes() + bytes(range(ext)) + payload


def parsed(fn):
    try:
        array, header, ext = fn()
    except ValueError:
        return "ValueError"
    return array.dtype, array.shape, array.tobytes(), header.tobytes(), ext


@pytest.mark.parametrize("mode,ext", [(0, 0), (1, 0), (2, 0), (3, 0), (4, 0),
                                      (6, 0), (16, 0), (2, 96)])
def test_parse_and_read_give_the_arrays_they_gave(tmp_path, mode, ext):
    """`parse` and `read` against the JAX package's `parse`, which slices
    the payload out of the file's bytes: same dtype, shape, values, header
    and extended header, or the same refusal (modes 3 and 16 do not
    reshape to the header's sections in either)."""
    from spr_pick_tpu.data import mrc as jax_mrc

    content = mrc_bytes(mode, ext)
    path = tmp_path / "m.mrc"
    path.write_bytes(content)
    want = parsed(lambda: jax_mrc.parse(content))
    assert parsed(lambda: mrc.parse(content)) == want
    assert parsed(lambda: mrc.read(str(path))) == want
    with open(path, "rb") as f:
        assert parsed(lambda: mrc.read(f)) == want
    if want != "ValueError":
        assert mrc.read(str(path))[0].flags.writeable


# ----------------------------------------------------------------------
# The Picker: MRC paths quantised on its device against arrays.


@pytest.fixture(scope="module")
def picker(tmp_path_factory):
    """A CPU Picker on a float32 joint checkpoint written by the port, and
    two 90x100 MRCs (not 32-aligned) at different ranges."""
    d = tmp_path_factory.mktemp("device_quantise")
    torch.manual_seed(0)
    c = cfg_mod.base()
    c[CV.ALGORITHM] = NoiseAlgorithm.SELFSUPERVISED_DENOISING
    c[CV.NOISE_STYLE] = "gauss"
    c[CV.NOISE_VALUE] = NoiseValue.UNKNOWN_CONSTANT
    c[CV.COMPUTE_DTYPE] = "f32"
    den = Denoiser(c, mode="joint", device="cpu")
    wt = str(d / "joint.wt")
    ckpt.save_weights(wt, *den.variables(), c, "joint")
    rng = np.random.RandomState(0)
    paths = []
    for i, (scale, offset) in enumerate(((3.0, 10.0), (0.01, -5.0))):
        x = (rng.randn(90, 100) * scale + offset).astype(np.float32)
        paths.append(write_mrc(str(d / f"mic{i}.mrc"), x))
    return Picker(wt, device="cpu", threshold=0.0), paths


def counted(fn):
    """``fn()``, the rise of the counter, and the root span's count."""
    before = profiling.counters().get(COUNTER, 0)
    t0 = time.perf_counter_ns()
    out = fn()
    roots = [r for r in profiling.spans()
             if r.start_ns >= t0 and r.name == "spr.request"]
    assert len(roots) == 1
    return (out, profiling.counters().get(COUNTER, 0) - before,
            roots[0].attrs.get(COUNTER, 0))


def assert_same_table(got, want):
    assert list(got) == list(want) and len(want["score"]) > 0
    for k in want:
        if want[k].dtype == np.float32:
            np.testing.assert_array_equal(bits(got[k]), bits(want[k]))
        else:
            np.testing.assert_array_equal(got[k], want[k])


def assert_same(got, want):
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            assert_same(g, w)
    elif isinstance(want, dict):
        assert_same_table(got, want)
    else:
        np.testing.assert_array_equal(bits(got), bits(want))


CALLS = {
    "pick_many_table": lambda p, im: p.pick_many_table([im], names=["m"]),
    "denoise": lambda p, im: p.denoise(im),
    "process_table": lambda p, im: p.process_table(im, name="m"),
}


@pytest.mark.parametrize("call", sorted(CALLS))
def test_path_call_equals_the_array_call(picker, call):
    p, paths = picker
    for path in paths:
        got, rise, on_root = counted(lambda: CALLS[call](p, path))
        assert rise == on_root == 1
        want, rise, on_root = counted(lambda: CALLS[call](p, load_image(path)))
        assert rise == on_root == 0
        assert_same(got, want)


def test_one_forward_over_paths_and_arrays(picker):
    """A batched group counts each micrograph quantised on the device; in
    a group of a path and an array only the path's row is quantised."""
    p, paths = picker
    arrays = [load_image(path) for path in paths]
    want, rise, _ = counted(lambda: p.pick_many_table(
        arrays, batch_size=2, names=["a", "b"]))
    assert rise == 0
    for images, n in ((paths, 2), ([paths[0], arrays[1]], 1),
                      ([arrays[0], paths[1]], 1)):
        got, rise, on_root = counted(lambda: p.pick_many_table(
            images, batch_size=2, names=["a", "b"]))
        assert rise == on_root == n
        assert_same_table(got, want)


@pytest.mark.parametrize("route", ["standardize", "tiled"])
def test_host_routes_do_not_count(picker, monkeypatch, route):
    """``standardize=True`` decodes on the host: the counter stays where
    it was.  A frame over the tiling threshold is quantised on the device
    before its windows are cut: the counter rises by one.  Either way the
    path call equals the array call bit for bit."""
    p, paths = picker
    standardize = route == "standardize"
    if route == "tiled":
        monkeypatch.setattr(p.evaluator, "tile_eval_threshold", 64)
        monkeypatch.setattr(p.evaluator, "tile_eval_size", 64)
        monkeypatch.setattr(p.evaluator, "tile_eval_halo", 16)
        assert p.evaluator.tiled(load_image(paths[0]).shape)
    got, rise, on_root = counted(lambda: p.denoise(paths[0], standardize))
    assert rise == on_root == (route == "tiled")
    want = p.denoise(load_image(paths[0], standardize=standardize))
    np.testing.assert_array_equal(bits(got), bits(want))


# ----------------------------------------------------------------------
# On the card.


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the device quantise is held on the "
                    "card there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_equals_host_on_the_benchmark_pool(cuda, tmp_path):
    """The benchmark's pool of 16 1024^2 micrographs from two seeds: each
    alone and all 16 in one batch, card == host decode bit for bit."""
    from gpubench import data as bench_data

    with open(os.path.join(ROOT, "gpubench", "traffic", "pick1k.json")) as f:
        mix = json.load(f)
    for seed in (3160000001, 2 ** 31 + 16):
        d = tmp_path / str(seed)
        d.mkdir()
        paths = bench_data.write_pool(bench_data.pool(seed, mix), str(d))
        raw = np.stack([np.asarray(mrc.read(p)[0], np.float32)
                        for p in paths])
        want = bits(np.stack([load_image(p) for p in paths]))
        np.testing.assert_array_equal(bits(on_device(raw, cuda)), want)
        for i in range(len(paths)):
            np.testing.assert_array_equal(
                bits(on_device(raw[i:i + 1], cuda)), want[i:i + 1])


@pytest.mark.cuda
def test_card_batch_of_three(cuda):
    x = three_ranges()
    got = on_device(x, cuda)
    for i in range(3):
        np.testing.assert_array_equal(bits(got[i]), bits(host(x[i])))
    for scale, offset in RANGES:
        y = (np.random.default_rng(5).standard_normal((2, 64, 64)) * scale
             + offset).astype(np.float32)
        np.testing.assert_array_equal(
            bits(on_device(y, cuda)),
            bits(np.stack([host(a) for a in y])))
