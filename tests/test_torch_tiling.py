"""Halo tiling: the port's pure functions against the JAX package's.

`spr_pick_tpu_torch/parallel/tiling.py` keeps windows and maps as torch
tensors; the JAX package's as numpy arrays.  The same seeded images go
through both over a grid of shapes, tiles and halos (odd shapes, windows
clamped at both ends, windows that span the whole extent): tile plans,
windows, offsets and stitched maps must be equal, `usable_halos` the same
tuple, `tiled_dense_apply` over a fixed 9x9 conv equal within 1e-5 with
the same alignment bump and refusal, and
`calibrate_halo` the same halo and curve within 1e-6 with the same
refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from spr_pick_tpu.parallel import tiling as jt
from spr_pick_tpu_torch.parallel import tiling as pt

# (H, W, tile, halo): interior and clamped windows, odd sizes, a window
# that spans the whole extent in one or both dimensions.
GEOMETRIES = [
    (300, 257, 128, 16),
    (300, 257, 64, 32),
    (64, 1000, 128, 32),
    (64, 1000, 96, 8),
    (200, 300, 128, 16),
    (100, 90, 64, 32),
    (256, 256, 64, 8),
    (513, 129, 160, 48),
]


def _image(h, w, seed=0):
    return np.random.RandomState(seed).rand(h, w).astype(np.float32)


def _tensor(img):
    """A torch copy: JAX may alias a numpy array's memory on the CPU."""
    return torch.from_numpy(img.copy())


@pytest.mark.parametrize("h,w,tile,halo", GEOMETRIES)
def test_extract_tiles_matches_jax(h, w, tile, halo):
    img = _image(h, w)
    want, grid_w, off_w = jt.extract_tiles(img, tile, halo)
    got, grid_g, off_g = pt.extract_tiles(_tensor(img), tile, halo)
    assert grid_g == grid_w == pt.plan_tiles(h, w, tile) == jt.plan_tiles(
        h, w, tile)
    np.testing.assert_array_equal(off_g, off_w)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("h,w,tile,halo", GEOMETRIES)
def test_stitch_tiles_matches_jax(h, w, tile, halo):
    img = _image(h, w, seed=1)
    tiles, grid, offsets = jt.extract_tiles(img, tile, halo)
    tiles = tiles * 2.0 + 1.0  # stitch something other than the input
    want = jt.stitch_tiles(tiles, grid, tile, offsets, (h, w))
    got = pt.stitch_tiles(_tensor(tiles), grid, tile, offsets, (h, w))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, img * 2.0 + 1.0)


@pytest.mark.parametrize("h,w,tile,halo", GEOMETRIES)
def test_usable_halos_matches_jax(h, w, tile, halo):
    halos = (halo // 2, halo, 2 * halo, 32, 64, 96, 128)
    assert pt.usable_halos((h, w), tile, halos) == jt.usable_halos(
        (h, w), tile, halos)


def _kernels(seed=0):
    rng = np.random.RandomState(seed)
    return [((rng.rand(9, 9) - 0.5) * 0.3).astype(np.float32) for _ in range(2)]


def _shifted_sum(pad, zeros, x, k):
    """x (B, H, W); a 2-D cross-correlation with zero SAME padding written
    as a sum of shifted products in a fixed order, in either framework:
    every pixel's value depends only on its neighbourhood, bit for bit,
    whatever the window (a library conv may pick another algorithm, with
    other rounding, for another shape)."""
    r = k.shape[0] // 2
    h, w = x.shape[1:3]
    xp = pad(x, r)
    out = zeros(x)
    for dy in range(k.shape[0]):
        for dx in range(k.shape[1]):
            out = out + float(k[dy, dx]) * xp[:, dy : dy + h, dx : dx + w]
    return out


def _conv_jax(x, k):
    return _shifted_sum(
        lambda a, r: jnp.pad(a, ((0, 0), (r, r), (r, r))), jnp.zeros_like,
        x[..., 0], k)[..., None]


def _conv_torch(x, k):
    return _shifted_sum(
        lambda a, r: F.pad(a, (r, r, r, r)), torch.zeros_like,
        x[..., 0], k)[..., None]


def _apply_pair(kind, ks):
    """(port apply, JAX apply) of one toy dense model.  The nonlinearity is
    a relu, which rounds nothing: with a tanh the port's direct output moved
    by ~2.5e-5 (p99) against its own tiles in about one run in three of
    this file, which the 1e-5 tolerance of the calibration cannot take."""
    if kind == "conv":
        return (lambda b: {"out": _conv_torch(b, ks[0])},
                lambda b: {"out": _conv_jax(b, ks[0])})
    if kind == "two_convs":
        return (
            lambda b: {"out": _conv_torch(torch.relu(_conv_torch(b, ks[0])),
                                          ks[1])},
            lambda b: {"out": _conv_jax(jax.nn.relu(_conv_jax(b, ks[0])),
                                        ks[1])},
        )
    # a global op: no halo can tile it
    return (lambda b: {"out": b - b.mean(dim=(1, 2), keepdim=True)},
            lambda b: {"out": b - jnp.mean(b, axis=(1, 2), keepdims=True)})


@pytest.mark.parametrize("h,w,tile,halo,align,max_batch", [
    (250, 190, 64, 8, 1, None),
    (300, 257, 64, 32, 32, None),   # full-extent windows padded to 32
    (256, 256, 64, 50, 32, 3),      # halo 50 bumped to 64; 16 tiles by 3
    (64, 1000, 128, 32, 32, 2),
])
def test_tiled_dense_apply_matches_jax(h, w, tile, halo, align, max_batch):
    img = _image(h, w, seed=2)
    port_fn, jax_fn = _apply_pair("conv", _kernels())
    want = jt.tiled_dense_apply(jax_fn, img, tile=tile, halo=halo,
                                max_batch=max_batch, align=align)["out"]
    got = pt.tiled_dense_apply(port_fn, _tensor(img), tile=tile,
                               halo=halo, max_batch=max_batch,
                               align=align)["out"]
    assert got.shape == (h, w)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_tiled_alignment_bump_is_the_wider_halo():
    img = torch.from_numpy(_image(256, 256, seed=3))
    port_fn, _ = _apply_pair("conv", _kernels(1))
    bumped = pt.tiled_dense_apply(port_fn, img, tile=64, halo=50, align=32)
    explicit = pt.tiled_dense_apply(port_fn, img, tile=64, halo=64, align=32)
    assert torch.equal(bumped["out"], explicit["out"])


def test_tiled_unalignable_halo_raises_like_jax():
    img = np.zeros((256, 256), np.float32)
    with pytest.raises(ValueError, match="no aligned") as want:
        jt.tiled_dense_apply(lambda b: {"out": b}, img, tile=63, halo=8,
                             align=32)
    with pytest.raises(ValueError, match="no aligned") as got:
        pt.tiled_dense_apply(lambda b: {"out": b}, _tensor(img),
                             tile=63, halo=8, align=32)
    assert str(got.value) == str(want.value)


def test_calibrate_halo_matches_jax():
    """Two chained 9x9 convs (receptive field 17): halo 4 leaks, halo 8 is
    exact; both packages stop at 8 with the same curve."""
    img = _image(96, 96, seed=4)
    port_fn, jax_fn = _apply_pair("two_convs", _kernels(2))
    want = jt.calibrate_halo(jax_fn, img, tile=32, tol=1e-5, halos=(4, 8, 16))
    got = pt.calibrate_halo(port_fn, _tensor(img), tile=32, tol=1e-5,
                            halos=(4, 8, 16))
    assert got[0] == want[0] == 8
    assert sorted(got[1]) == sorted(want[1]) == [4, 8]
    for h in want[1]:
        assert abs(got[1][h] - want[1][h]) <= 1e-6
    assert got[1][4] > 1e-5


@pytest.mark.parametrize("case,kind,shape,tile,halos,match", [
    ("probe too small", "conv", (40, 40), 32, (8, 16), "too small"),
    ("optimistic geometry", "two_convs", (96, 96), 64, (4, 8), "soundly"),
    ("no halo suffices", "global", (96, 96), 32, (4, 8, 16),
     "no candidate halo"),
])
def test_calibrate_halo_refuses_like_jax(case, kind, shape, tile, halos,
                                         match):
    img = _image(*shape, seed=5)
    port_fn, jax_fn = _apply_pair(kind, _kernels(3))
    with pytest.raises(ValueError, match=match) as want:
        jt.calibrate_halo(jax_fn, img, tile=tile, tol=1e-6, halos=halos)
    with pytest.raises(ValueError, match=match) as got:
        pt.calibrate_halo(port_fn, _tensor(img), tile=tile, tol=1e-6,
                          halos=halos)
    want_curve = getattr(want.value, "curve", {})
    got_curve = getattr(got.value, "curve", {})
    assert sorted(got_curve) == sorted(want_curve)
    for h in want_curve:
        assert abs(got_curve[h] - want_curve[h]) <= 1e-6
