"""The slice end to end: the port's Picker against the JAX Picker.

A random-init joint checkpoint (ssdn, gauss, const) is written by the JAX
package in float32 compute, with the A half of the U-Net head zeroed so
z == mu and the two frameworks' different sample noise drops out.  Both
Pickers read it and pick the same micrographs: a 128^2 MRC and a 96x128
array (the rectangular two-lane fold), and two that are not on the 32-px
grid and take the trailing reflect pad and the crop of the padded heatmap:
a 100^2 MRC and a 90x150 array.  Pick sets must be identical, scores
within 1e-5 and the denoised image within 1e-5 (float32 conv accumulation
order).
"""

import jax
import numpy as np
import pytest

from spr_pick_tpu import cfg as jax_cfg
from spr_pick_tpu.api import Picker as JPicker
from spr_pick_tpu.denoiser import Denoiser as JDenoiser
from spr_pick_tpu.params import ConfigValue as JCV
from spr_pick_tpu.params import NoiseAlgorithm as JNoiseAlgorithm
from spr_pick_tpu.params import NoiseValue as JNoiseValue
from spr_pick_tpu.utils import checkpoint as jax_ckpt
from spr_pick_tpu_torch.api import Picker
from spr_pick_tpu_torch.data import mrc

ATOL = 1e-5


def make_jax_wt(path: str, noise_value: JNoiseValue) -> str:
    """JAX-written f32 `.wt` with the sigma (A) head zeroed.  The detector's
    classifier is scaled up so the heatmap spreads far beyond float32
    rounding, which keeps the pick order free of near-ties."""
    cfg = jax_cfg.base()
    cfg[JCV.ALGORITHM] = JNoiseAlgorithm.SELFSUPERVISED_DENOISING
    cfg[JCV.NOISE_STYLE] = "gauss"
    cfg[JCV.NOISE_VALUE] = noise_value
    cfg[JCV.COMPUTE_DTYPE] = "f32"
    den = JDenoiser(cfg, mode="joint")
    variables = jax.jit(lambda: den.init_variables(seed=0))()
    trainable, static = JDenoiser.split_trainable(variables)
    trainable = jax.tree_util.tree_map(lambda a: np.array(a), trainable)
    static = jax.tree_util.tree_map(lambda a: np.array(a), static)
    head = trainable["model"]["denoise_branch"]["out_conv"]["conv"]
    head["kernel"][..., 1] = 0.0
    head["bias"][1] = 0.0
    trainable["model"]["detector"]["classifier"]["classifier"]["kernel"] *= 20
    jax_ckpt.save_weights(path, trainable, static, cfg, "joint")
    return path


def assert_same_picks(got, want):
    """Same pick set; scores within ATOL."""
    assert len(got) == len(want) > 0
    key = ["image_name", "x_coord", "y_coord"]
    g = got.sort_values(key).reset_index(drop=True)
    w = want.sort_values(key).reset_index(drop=True)
    assert g[key].equals(w[key])
    np.testing.assert_allclose(g["score"], w["score"], atol=ATOL, rtol=0)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("api")
    wt = make_jax_wt(str(d / "const.wt"), JNoiseValue.UNKNOWN_CONSTANT)
    rng = np.random.RandomState(0)
    mic = str(d / "mic.mrc")
    mrc.write(mic, (rng.randn(128, 128) * 3 + 10).astype(np.float32))
    rect = rng.rand(96, 128).astype(np.float32)
    mic_pad = str(d / "mic_pad.mrc")
    mrc.write(mic_pad, (rng.randn(100, 100) * 3 + 10).astype(np.float32))
    odd = rng.rand(90, 150).astype(np.float32)
    return dict(wt=wt, mic=mic, rect=rect, mic_pad=mic_pad, odd=odd,
                jax=JPicker(wt), port=Picker(wt, device="cpu"))


@pytest.mark.parametrize("border", [0, 30])
def test_pick_matches_jax(setup, border):
    setup["jax"].border = setup["port"].border = border
    assert_same_picks(setup["port"].pick(setup["mic"]),
                      setup["jax"].pick(setup["mic"]))


def test_pick_rect_matches_jax(setup):
    setup["jax"].border = setup["port"].border = 0
    assert_same_picks(setup["port"].pick(setup["rect"], name="rect"),
                      setup["jax"].pick(setup["rect"], name="rect"))


@pytest.mark.parametrize("image,shape", [("mic_pad", (100, 100)),
                                         ("odd", (90, 150))])
def test_padded_micrograph_matches_jax(setup, image, shape):
    setup["jax"].border = setup["port"].border = 0
    assert_same_picks(setup["port"].pick(setup[image], name=image),
                      setup["jax"].pick(setup[image], name=image))
    got = setup["port"].denoise(setup[image])
    want = setup["jax"].denoise(setup[image])
    assert got.shape == want.shape == shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_pick_many_matches_jax(setup):
    setup["jax"].border = setup["port"].border = 30
    images = [setup["mic"], setup["mic"], setup["rect"]]
    names = ["a", "b", "c"]
    assert_same_picks(
        setup["port"].pick_many(images, batch_size=2, names=names),
        setup["jax"].pick_many(images, batch_size=2, names=names),
    )


def test_denoise_and_process_match_jax(setup):
    got = setup["port"].denoise(setup["mic"])
    want = setup["jax"].denoise(setup["mic"])
    assert got.shape == want.shape == (128, 128)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    setup["port"].border = 0
    picks, den = setup["port"].process(setup["rect"])
    assert den.shape == (96, 128)
    np.testing.assert_array_equal(den, setup["port"].denoise(setup["rect"]))
    assert_same_picks(picks, setup["port"].pick(setup["rect"]))


def test_pick_arrays_are_the_frame_columns(setup):
    port = setup["port"]
    port.border = 0
    scores, coords, shape = port.pick_arrays(setup["mic"])
    frame = port.pick(setup["mic"])
    assert shape == (128, 128)
    np.testing.assert_array_equal(frame["x_coord"], coords[:, 1])
    np.testing.assert_array_equal(frame["y_coord"], coords[:, 0])
    np.testing.assert_array_equal(frame["score"], scores)


def test_giant_micrograph_is_refused(setup):
    """Above 2048 px after padding the Picker no longer refuses: a 2050x64
    array (padded to 2080x64) takes halo tiling at the production knobs,
    three windows of 1216x64, and returns picks."""
    port = setup["port"]
    port.border = 0
    calls = []
    evaluate_tiled = port.evaluator.evaluate_tiled

    def counting(image, generator, image_shape):
        calls.append(tuple(image.shape))
        return evaluate_tiled(image, generator, image_shape)

    port.evaluator.evaluate_tiled = counting
    try:
        img = np.random.RandomState(3).rand(2050, 64).astype(np.float32)
        scores, coords, shape = port.pick_arrays(img)
    finally:
        del port.evaluator.evaluate_tiled
    assert calls == [(2080, 64)]
    assert shape == (2050, 64) and len(scores) > 0
    assert (coords[:, 0] < 64).all() and (coords[:, 1] < 2050).all()
