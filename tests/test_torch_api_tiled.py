"""Halo-tiled picking through the Picker: the port against the JAX package.

A 320x384 MRC with the tiling knobs lowered (threshold 256, tile 128, halo
32) takes the tiled route in both packages: 3x3 windows of 192^2, clamped at
the image edges and interior in the middle.  With the JAX-written float32
checkpoint of `tests/test_torch_api.py` (A half zeroed, so z == mu) the
port's tiled picks must equal JAX's (same set, scores within 1e-5), its
stitched denoised image JAX's within 1e-5, and ``tile_eval_halo="auto"``
must choose JAX's halo from the same deviation curve (within 1e-4: the
curve's p99 rides on float32 conv rounding in both packages).

The seeding guarantees of `tests/test_api.py:183-228` are checked on the
port alone, with a checkpoint whose A half is not zeroed (the sample noise
then moves the scores): repeated tiled picks and denoised images are
identical, each window chunk draws its own noise, and another seed gives
other scores.  `pick_many` sends giant micrographs one at a time.
"""

import numpy as np
import pytest
import torch

import spr_pick_tpu.parallel.tiling as jax_tiling
from spr_pick_tpu.api import Picker as JPicker
from spr_pick_tpu.params import NoiseValue as JNoiseValue
from spr_pick_tpu.params import PipelineOutput as JPipelineOutput
from spr_pick_tpu.steps import make_eval_step
from spr_pick_tpu_torch import cfg as cfg_mod
from spr_pick_tpu_torch.api import Picker
from spr_pick_tpu_torch.data import mrc
from spr_pick_tpu_torch.data.loader import load_image
from spr_pick_tpu_torch.denoiser import Denoiser
from spr_pick_tpu_torch.params import ConfigValue, NoiseAlgorithm, NoiseValue
from spr_pick_tpu_torch.utils import checkpoint as ckpt
from tests.test_torch_api import ATOL, assert_same_picks, make_jax_wt

SHAPE = (320, 384)


def lower_knobs(ev, halo=32):
    ev.tile_eval_threshold = 256
    ev.tile_eval_size = 128
    ev.tile_eval_halo = halo


def make_port_wt(path: str) -> str:
    """A port-written float32 `.wt` straight from a seeded init: the A half
    is live, so the sample noise reaches the detector."""
    c = cfg_mod.base()
    c[ConfigValue.ALGORITHM] = NoiseAlgorithm.SELFSUPERVISED_DENOISING
    c[ConfigValue.NOISE_STYLE] = "gauss"
    c[ConfigValue.NOISE_VALUE] = NoiseValue.UNKNOWN_CONSTANT
    c[ConfigValue.COMPUTE_DTYPE] = "f32"
    den = Denoiser(c, device="cpu")
    den.init_variables(seed=1)
    ckpt.save_weights(path, *den.variables(), c, "joint")
    return path


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("api_tiled")
    wt = make_jax_wt(str(d / "const.wt"), JNoiseValue.UNKNOWN_CONSTANT)
    mic = str(d / "mic.mrc")
    rng = np.random.RandomState(0)
    mrc.write(mic, (rng.randn(*SHAPE) * 3 + 10).astype(np.float32))
    port = Picker(wt, device="cpu")
    jax_picker = JPicker(wt)
    lower_knobs(port.evaluator)
    lower_knobs(jax_picker._ev)
    picks, den = port.process(mic)
    return dict(wt=wt, mic=mic, port=port, jax=jax_picker, picks=picks,
                den=den)


def test_tiled_pick_matches_jax(setup):
    assert_same_picks(setup["picks"], setup["jax"].pick(setup["mic"]))


def test_tiled_denoise_matches_jax(setup):
    want = setup["jax"].denoise(setup["mic"])
    assert setup["den"].shape == want.shape == SHAPE
    np.testing.assert_allclose(setup["den"], want, atol=ATOL, rtol=0)


def _jax_apply_tiles(ev):
    """The JAX evaluator's tile apply fn (train.py:1126-1136)."""
    if ev._eval_step is None:
        ev._eval_step = make_eval_step(ev.denoiser, dense=True)

    def apply_tiles(chunk):
        outputs = ev._eval_step(ev.train_state, {"inp": chunk}, ev._next_rng())
        return {k: v for k, v in outputs.items()
                if getattr(v, "ndim", 0) == 4
                and v.shape[1:3] == chunk.shape[1:3]}

    assert JPipelineOutput.DETECT  # the maps calibrated include the heatmap
    return apply_tiles


def test_auto_halo_matches_jax(setup, monkeypatch):
    img = load_image(setup["mic"])
    # The JAX evaluator logs its curve; record it from its calibrate_halo.
    seen = {}
    calibrate = jax_tiling.calibrate_halo

    def recording(*args, **kw):
        try:
            seen["result"] = calibrate(*args, **kw)
        except ValueError as exc:
            seen["curve"] = exc.curve
            raise
        seen["curve"] = seen["result"][1]
        return seen["result"]

    monkeypatch.setattr(jax_tiling, "calibrate_halo", recording)
    jev = setup["jax"]._ev
    want = jev._calibrated_halo(_jax_apply_tiles(jev), img, SHAPE)

    ev = setup["port"].evaluator
    apply_tiles = ev._tile_apply_fn(torch.Generator().manual_seed(0))
    got = ev._calibrated_halo(apply_tiles, torch.from_numpy(img), SHAPE)
    assert got == want
    curve = ev._auto_halo[2]
    assert sorted(curve) == sorted(seen["curve"]) == [32, 64]
    for h, dev in seen["curve"].items():
        assert abs(curve[h] - dev) <= 1e-4

    # The certificate is cached per weight set: no new forward.
    calls = []
    ev._calibrated_halo(lambda chunk: calls.append(1), torch.from_numpy(img),
                        SHAPE)
    assert calls == []


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    """A port checkpoint with a live A half and a 288x160 array, which
    tiles into 3x2 windows of 192x160 at the lowered knobs."""
    d = tmp_path_factory.mktemp("seeded")
    wt = make_port_wt(str(d / "live_a.wt"))
    img = np.random.RandomState(1).rand(288, 160).astype(np.float32)
    picker = Picker(wt, seed=3, border=0, device="cpu")
    lower_knobs(picker.evaluator)
    return dict(wt=wt, img=img, picker=picker)


def test_tiled_route_is_deterministic_and_seeded(seeded):
    picker, img = seeded["picker"], seeded["img"]
    states = []
    sample = picker.denoiser.model.sample

    def recording(out_stats, eps=None, generator=None):
        states.append(generator.get_state().clone())
        return sample(out_stats, eps, generator)

    picker.denoiser.model.sample = recording
    try:
        first, den_a = picker.process(img)
        second, den_b = picker.process(img)
    finally:
        del picker.denoiser.model.sample
    assert len(first) > 0
    assert first.equals(second)
    np.testing.assert_array_equal(den_a, den_b)
    # Six windows, one forward each: six different noise fields a call,
    # the same six in each call.
    assert len(states) == 12
    assert len({bytes(s.numpy()) for s in states[:6]}) == 6
    assert all(torch.equal(a, b) for a, b in zip(states[:6], states[6:]))

    other = Picker(seeded["wt"], seed=4, border=0, device="cpu")
    lower_knobs(other.evaluator)
    third = other.pick(img)
    assert not (len(third) == len(first)
                and np.array_equal(third[["x_coord", "y_coord"]].to_numpy(),
                                   first[["x_coord", "y_coord"]].to_numpy())
                and np.array_equal(third.score.to_numpy(),
                                   first.score.to_numpy()))


def test_pick_many_sends_giant_micrographs_one_at_a_time(seeded):
    picker, img = seeded["picker"], seeded["img"]
    tiled = []
    evaluate_tiled = picker.evaluator.evaluate_tiled

    def counting(image, generator, image_shape):
        tiled.append(tuple(image.shape))
        return evaluate_tiled(image, generator, image_shape)

    picker.evaluator.evaluate_tiled = counting
    try:
        small = np.random.RandomState(2).rand(96, 96).astype(np.float32)
        got = picker.pick_many([img, img, small], batch_size=2,
                               names=["a", "b", "c"])
        want = picker.pick(img, name="a")
    finally:
        del picker.evaluator.evaluate_tiled
    assert tiled == [(288, 160)] * 3  # a, b, then the reference
    a = got[got.image_name == "a"].reset_index(drop=True)
    b = got[got.image_name == "b"].reset_index(drop=True)
    assert a.equals(want)
    assert a.drop(columns="image_name").equals(b.drop(columns="image_name"))
    assert (got.image_name == "c").sum() > 0
