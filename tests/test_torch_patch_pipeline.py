"""The port's training data planes against the JAX package's.

Both packages load the same synthetic manifest (`tests.test_e2e`) with
64-px crops; the same packed indices (drawn by the sampler) go into the
JAX `DevicePatchPipeline`/`HostPatchPipeline` and the port's, whose flips
both come from a `RandomState(0)`.  Patches, labels and flips must be
equal, exactly (a gather and numpy crops copy float32 values), over
several batches and across a `state_dict` round trip.  The labels are
heatmap values: the JAX package draws its heatmaps with a C++ rasteriser
when g++ is there, which its own tests hold to its numpy loop within 1e-6
(`tests/test_native.py`); the port has the numpy loop.  So the exact
comparison builds the JAX dataset with the rasteriser off, and the labels
of the rasteriser's dataset are held within 1e-6.  Beside them: the
host crop with zero fill at the borders (`train_item`), the bounds check,
and the device-budget refusal that sends the trainer to the host plane.
"""

import numpy as np
import pytest
import torch

from spr_pick_tpu.data import micrograph as jmic
from spr_pick_tpu_torch.data import micrograph as mic
from spr_pick_tpu_torch.data.sampler import (StratifiedCoordinateSampler,
                                             pack_index)
from tests.test_e2e import make_synthetic_dataset

CROP = 64
B = 16


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    images, coords = make_synthetic_dataset(tmp, np.random.RandomState(3),
                                            n_images=3, size=320)
    from spr_pick_tpu import native

    def jax_dataset():
        return jmic.MicrographDataset(images, coords, radius=3, train=True,
                                      crop=CROP, bb=24, verbose=False)

    native_ds = jax_dataset()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "available", lambda: False)
        jds = jax_dataset()
    ds = mic.MicrographDataset(images, coords, radius=3, crop=CROP, bb=24,
                               verbose=False)
    sampler = StratifiedCoordinateSampler(
        list(ds.targets), balance=0.1, size=10 ** 5,
        random=np.random.RandomState(0))
    packed = [sampler.sample_batch(B) for _ in range(4)]
    return jds, ds, packed, native_ds


def as_np(batch):
    return {k: np.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("plane", ["DevicePatchPipeline",
                                   "HostPatchPipeline"])
def test_batches_equal_jax(data, plane):
    jds, ds, packed, _ = data
    jp = getattr(jmic, plane)(jds, crop=CROP, augment=True)
    tp = getattr(mic, plane)(ds, crop=CROP, device="cpu")
    for p in packed[:2]:
        want, got = as_np(jp.batch(p)), tp.batch(p)
        assert got["inp"].shape == (B, CROP, CROP, 1)
        assert got["inp"].dtype == got["target"].dtype == torch.float32
        np.testing.assert_array_equal(got["inp"].numpy(), want["inp"])
        np.testing.assert_array_equal(got["target"].numpy(), want["target"])
    state = tp.state_dict()
    fresh = getattr(mic, plane)(ds, crop=CROP, device="cpu")
    fresh.load_state_dict(state)
    for p in packed[2:]:
        want = as_np(jp.batch(p))
        np.testing.assert_array_equal(fresh.batch(p)["inp"].numpy(),
                                      want["inp"])


def test_device_plane_equals_host_plane(data):
    _, ds, packed, _ = data
    dev = mic.DevicePatchPipeline(ds, crop=CROP, device="cpu")
    host = mic.HostPatchPipeline(ds, crop=CROP, device="cpu")
    for p in packed:
        a, b = dev.batch(p), host.batch(p)
        assert torch.equal(a["inp"], b["inp"])
        assert torch.equal(a["target"], b["target"])


def test_labels_are_read_at_the_centre_whatever_the_flip(data):
    _, ds, packed, _ = data
    dev = mic.DevicePatchPipeline(ds, crop=CROP, device="cpu")
    flat, ys, xs = dev.decode(packed[0])
    flips = np.arange(B) % 2
    patches = dev.gather(flat, ys, xs, flips)
    straight = dev.gather(flat, ys, xs, np.zeros(B, np.int64))
    assert torch.equal(patches[1::2], straight[1::2].flip(2))
    assert torch.equal(patches[0::2], straight[0::2])
    g, i = 0, 0
    w = ds.images[g][i].shape[1]
    label = dev.labels_for(*dev.decode(np.array([pack_index(g, i, 100 * w
                                                            + 90)])))
    assert label[0] == ds.hms[g][i][100, 90]


@pytest.mark.parametrize("xy", [(3, 5), (300, 10), (150, 318)])
def test_train_item_zero_pads_like_jax(data, xy):
    jds, ds, _, _ = data
    x, y = xy
    w = ds.images[0][1].shape[1]
    h = pack_index(0, 1, y * w + x)
    got, want = ds.train_item(h), jds.train_item(h)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


def test_bounds_check_and_budget(data):
    _, ds, _, _ = data
    dev = mic.DevicePatchPipeline(ds, crop=CROP, device="cpu")
    w = ds.images[0][0].shape[1]
    with pytest.raises(ValueError, match="out of bounds"):
        dev.batch(np.array([pack_index(0, 0, 10 * w + 100)]))
    with pytest.raises(ValueError, match="device data-plane budget"):
        mic.DevicePatchPipeline(ds, crop=CROP, max_bytes=1000, device="cpu")


def test_labels_within_1e6_of_the_native_rasteriser(data):
    _, ds, packed, native_ds = data
    want = jmic.HostPatchPipeline(native_ds, crop=CROP).batch(packed[0])
    got = mic.HostPatchPipeline(ds, crop=CROP, device="cpu").batch(packed[0])
    np.testing.assert_allclose(got["target"].numpy(),
                               np.asarray(want["target"]), rtol=0, atol=1e-6)
