"""The denoise data plane of the port against the JAX package's.

  * Host plane, bit for bit from the same `RandomState`: `add_style` (gauss
    fixed, range, `_nc`; poisson fixed and range), `manipulate` on a
    multiple and a non-multiple of the 8-px grid, `prepare_batch` for the
    five algorithms with and without `noise_input`, `random_crop` (plain,
    reflect-padded, labeled-only) and `DenoisePatchPipeline.batch`.
  * Device plane: the image stack, the budget gate, `sample_coords` and the
    state a JAX-written `.training` carries (restored exactly; the
    generator reseeded from the batch count) equal the JAX package's.
  * The device plane's functions fed the draws the JAX package makes from
    its keys (`fold_in` -> `split` as in patches.py:200-203, noisy.py:103,
    noise.py:102 and n2v.py:93-131): `add_style_torch` == `add_style_jax`
    and `manipulate_torch` == `manipulate_jax`, bit for bit; and UPS's
    properties on the port's own draws: one target per full 8x8 cell, the
    donor another pixel of the target's clipped 5x5 window, and only
    in-range cells on sizes that are not multiples of 8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spr_pick_tpu.data import crop as jcrop
from spr_pick_tpu.data import n2v as jn2v
from spr_pick_tpu.data import noise as jnoise
from spr_pick_tpu.data import noisy as jnoisy
from spr_pick_tpu.data import patches as jpatches
from spr_pick_tpu.params import NoiseAlgorithm as JNA
from spr_pick_tpu_torch.data import crop, n2v, noise, noisy, patches
from spr_pick_tpu_torch.params import NoiseAlgorithm

STYLES = ["gauss25", "gauss10_50", "gauss25_nc", "poisson30", "poisson10_50"]
ALGORITHMS = [a.value for a in NoiseAlgorithm]


def images(b=3, h=16, w=20, seed=0):
    return np.random.RandomState(seed).rand(b, h, w).astype(np.float32)


def assert_same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# Host plane: the numpy copies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("style", STYLES)
def test_add_style_is_the_jax_draw(style):
    x = images()
    got = noise.add_style(x, style, rng=np.random.RandomState(7))
    want = jnoise.add_style(x, style, rng=np.random.RandomState(7))
    assert_same(got[0], want[0])
    assert_same(got[1], want[1])
    if style.endswith("_nc"):
        assert got[0].min() < 0 or got[0].max() > 1


@pytest.mark.parametrize("shape", [(64, 64), (30, 37)])
def test_manipulate_is_the_jax_draw(shape):
    x = images(1, *shape)[0]
    got = n2v.manipulate(x, 5, rng=np.random.RandomState(3))
    want = jn2v.manipulate(x, 5, rng=np.random.RandomState(3))
    assert_same(got[0], want[0])
    assert_same(got[1], want[1])


@pytest.mark.parametrize("noise_input", [False, True], ids=["clean", "noisy"])
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_prepare_batch_is_the_jax_batch(algorithm, noise_input):
    x = images()
    got = noisy.prepare_batch(x, NoiseAlgorithm(algorithm), "gauss10_40",
                              np.random.RandomState(5),
                              noise_input=noise_input)
    want = jnoisy.prepare_batch(x, JNA(algorithm), "gauss10_40",
                                np.random.RandomState(5),
                                noise_input=noise_input)
    assert got.keys() == want.keys()
    for k in want:
        assert_same(got[k], want[k])
    assert ("noise_std" in got) == noise_input
    assert ("mask" in got) == (algorithm == "n2v")


@pytest.mark.parametrize("case", ["plain", "padded", "labeled"])
def test_random_crop_is_the_jax_crop(case):
    rng = np.random.RandomState(9)
    shape = (20, 18) if case == "padded" else (50, 60)
    img = rng.rand(*shape).astype(np.float32)
    hm = None
    if case == "labeled":
        hm = np.zeros(shape, np.float32)
        hm[40:44, 50:55] = 1.0
    for _ in range(3):
        got = crop.random_crop(img, hm, 32, rng_a := np.random.RandomState(1),
                               labeled_only=case == "labeled")
        want = jcrop.random_crop(img, hm, 32, np.random.RandomState(1),
                                 labeled_only=case == "labeled")
        assert_same(got[0], want[0])
        assert got[2] == want[2]
        if hm is not None:
            assert_same(got[1], want[1])
        img = img + float(rng_a.rand())


def folder(seed=0):
    """An in-memory image set: a 64x80, a 50x40 (under the 32-px patch on
    neither side) and a 20x70 that the device plane reflect-pads."""
    rng = np.random.RandomState(seed)
    return [rng.rand(*s).astype(np.float32)
            for s in ((64, 80), (50, 40), (20, 70))]


@pytest.mark.parametrize("algorithm,style,noise_input", [
    ("n2v", "gauss25", False), ("n2n", "poisson10_50", True)])
def test_denoise_patch_pipeline_is_the_jax_pipeline(algorithm, style,
                                                    noise_input):
    data = folder()
    got = patches.DenoisePatchPipeline(data, 32, NoiseAlgorithm(algorithm),
                                       style, seed=4, noise_input=noise_input)
    want = jpatches.DenoisePatchPipeline(data, 32, JNA(algorithm), style,
                                         seed=4, noise_input=noise_input)
    for _ in range(3):
        g, w = got.batch(4), want.batch(4)
        assert g.keys() == w.keys()
        for k in w:
            assert isinstance(g[k], torch.Tensor)
            assert_same(g[k].numpy(), w[k])
    got2 = patches.DenoisePatchPipeline(data, 32, NoiseAlgorithm(algorithm),
                                        style, seed=0, noise_input=noise_input)
    got2.load_state_dict(want.state_dict())
    assert_same(got2.batch(4)["inp"].numpy(), want.batch(4)["inp"])


# ---------------------------------------------------------------------------
# Device plane: stack, coordinates, resumable state
# ---------------------------------------------------------------------------

def device_pipelines(data, seed=2, **kw):
    got = patches.DeviceDenoisePipeline(data, 32, NoiseAlgorithm.NOISE_TO_VOID,
                                        "gauss25", seed=seed, **kw)
    want = jpatches.DeviceDenoisePipeline(data, 32, JNA.NOISE_TO_VOID,
                                          "gauss25", seed=seed, **kw)
    return got, want


def test_device_stack_and_sample_coords_are_jax_s():
    got, want = device_pipelines(folder())
    assert_same(got.images_dev.numpy(), want._images_host)
    assert_same(got.heights, want.heights)
    assert_same(got.widths, want.widths)
    for shape in ((5,), (3, 4)):
        for g, w in zip(got.sample_coords(shape), want.sample_coords(shape)):
            assert_same(g, w)
    with pytest.raises(ValueError, match="budget"):
        device_pipelines(folder(), max_bytes=10_000)


def test_device_gather_cuts_the_coordinates_crops():
    data = folder()
    got, _ = device_pipelines(data)
    flat, ys, xs = got.sample_coords((6,))
    crops = got.gather(flat, ys, xs).numpy()
    for c, f, y, x in zip(crops, flat, ys, xs):
        img = got.images_dev[f].numpy()
        assert_same(c, img[y : y + 32, x : x + 32])
        assert y + 32 <= got.heights[f] and x + 32 <= got.widths[f]


def test_device_plane_resumes_a_jax_written_state():
    """A JAX-written state (numpy RandomState + key_counter, no generator):
    the crop draws continue exactly; the generator is reseeded from the
    batch count.  The port's own state also restores the generator."""
    data = folder()
    got, want = device_pipelines(data)
    want.sample_coords((4,))
    want._key_counter = 3
    port, _ = device_pipelines(data, seed=0)
    port.load_state_dict(want.state_dict())
    assert port._key_counter == 3
    for g, w in zip(port.sample_coords((5,)), want.sample_coords((5,))):
        assert_same(g, w)
    again, _ = device_pipelines(data, seed=0)
    again.load_state_dict(want.state_dict() | {"rng_state": port.rng.get_state()})
    assert torch.equal(again.generator.get_state(), port.generator.get_state())
    state = port.state_dict()
    a = port.batch(4)
    resumed, _ = device_pipelines(data, seed=7)
    resumed.load_state_dict(state)
    b = resumed.batch(4)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# The device plane's functions on JAX's draws
# ---------------------------------------------------------------------------

def jax_prep_keys(seed=11, counter=2):
    """The keys of one device-plane batch: fold_in(PRNGKey(seed ^ 0x5EED),
    counter) split into (k_in, k_ref, k_ups) (patches.py:200-203,
    noisy.py:103)."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed ^ 0x5EED), counter)
    return jax.random.split(key, 3)


@pytest.mark.parametrize("style", STYLES)
def test_add_style_torch_equals_add_style_jax_on_its_draws(style):
    x = images(4, 12, 10)
    _, k_ref, _ = jax_prep_keys()
    want, want_coeff = jnoise.add_style_jax(jnp.asarray(x), style, k_ref)
    k_param, k_noise = jax.random.split(k_ref)
    u = np.array(jax.random.uniform(k_param, (4, 1, 1)))
    if style.startswith("gauss"):
        n = np.array(jax.random.normal(k_noise, x.shape, jnp.float32))
    else:
        n = np.asarray(jax.random.poisson(k_noise, 1.0, x.shape)
                       ).astype(np.float32)
    got, coeff = noise.add_style_torch(torch.from_numpy(x), style,
                                       uniform=torch.from_numpy(u),
                                       noise=torch.from_numpy(n))
    assert_same(got.numpy(), want)
    assert_same(coeff.numpy(), want_coeff)


def ups_draws(b, h, w, k_ups):
    """manipulate_jax's three uniforms, stacked over the batch
    (n2v.py:93-101, 116, 131)."""
    by, bx = n2v.grid_shape(h, w)
    draws = []
    for k in jax.random.split(k_ups, b):
        k_y, k_x, k_donor = jax.random.split(k, 3)
        draws.append([np.array(jax.random.uniform(kk, (by, bx)))
                      for kk in (k_y, k_x, k_donor)])
    return [torch.from_numpy(np.stack(d)) for d in zip(*draws)]


@pytest.mark.parametrize("shape", [(64, 64), (30, 37)])
def test_manipulate_torch_equals_manipulate_jax_on_its_draws(shape):
    x = images(3, *shape)
    _, _, k_ups = jax_prep_keys()
    want_out, want_mask = jn2v.manipulate_jax(jnp.asarray(x), k_ups, 5)
    got_out, got_mask = n2v.manipulate_torch(torch.from_numpy(x),
                                             *ups_draws(3, *shape, k_ups))
    assert_same(got_out.numpy(), want_out)
    assert_same(got_mask.numpy(), want_mask)


@pytest.mark.parametrize("shape", [(64, 64), (30, 37)])
def test_ups_properties(shape):
    h, w = shape
    b = 4
    # Every pixel a distinct value, so a replaced pixel names its donor.
    img = torch.arange(b * h * w, dtype=torch.float32).reshape(b, h, w)
    out, mask = n2v.manipulate_torch(
        img, generator=torch.Generator().manual_seed(0))
    by, bx = n2v.grid_shape(h, w)
    for i in range(b):
        ys, xs = np.nonzero(mask[i].numpy())
        # Full cells: exactly one target each; every target in range.
        cells = {(y // 8, x // 8) for y, x in zip(ys, xs)}
        assert len(cells) == len(ys)
        assert {(cy, cx) for cy in range(h // 8) for cx in range(w // 8)} \
            <= cells
        assert len(ys) <= by * bx
        for y, x in zip(ys, xs):
            donor = int(out[i, y, x]) - i * h * w
            dy, dx = divmod(donor, w)
            assert (dy, dx) != (y, x)
            assert max(y - 2, 0) <= dy <= min(y + 2, h - 1)
            assert max(x - 2, 0) <= dx <= min(x + 2, w - 1)
        untouched = mask[i] == 0
        assert torch.equal(out[i][untouched], img[i][untouched])
    if h % 8 or w % 8:
        # Some cells of the partial row/column fell outside and were dropped.
        assert int(mask.sum()) < b * by * bx


def test_prepare_batch_torch_matrix():
    """The algorithm matrix on the device plane: the keys each algorithm
    gives, the n2c reference the clean crop, the ssdn_u_only reference its
    input, noise_input's (B,1,1,1) s.d."""
    x = torch.from_numpy(images(2, 32, 32))
    g = torch.Generator().manual_seed(1)
    for algorithm in NoiseAlgorithm:
        for noise_input in (False, True):
            batch = noisy.prepare_batch_torch(x, algorithm, "gauss25", g,
                                              noise_input=noise_input)
            keys = {"inp"}
            if algorithm != NoiseAlgorithm.SELFSUPERVISED_DENOISING:
                keys.add("ref")
            if algorithm == NoiseAlgorithm.NOISE_TO_VOID:
                keys.add("mask")
            if noise_input:
                keys.add("noise_std")
                assert batch["noise_std"].shape == (2, 1, 1, 1)
            assert set(batch) == keys
            assert batch["inp"].shape == (2, 32, 32, 1)
            if algorithm == NoiseAlgorithm.NOISE_TO_CLEAN:
                assert torch.equal(batch["ref"][..., 0], x)
            if algorithm == NoiseAlgorithm.SELFSUPERVISED_DENOISING_MEAN_ONLY:
                assert torch.equal(batch["ref"], batch["inp"])
            if not noise_input and algorithm in (
                    NoiseAlgorithm.SELFSUPERVISED_DENOISING,
                    NoiseAlgorithm.NOISE_TO_NOISE):
                assert torch.equal(batch["inp"][..., 0], x)
