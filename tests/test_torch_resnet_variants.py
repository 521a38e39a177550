"""ResNet6, ResNet16 and the shift-and-stitch dense detector of the PyTorch
port against the flax modules on the same weights.

Weights come from the port's seeded init with every bias and BatchNorm
statistic randomised (`tests/test_torch_models.py:randomize`), carried to
flax by `weights.state_to_flax`; both packages run the same numpy input in
float32.  Tolerance: atol 1e-5 (float32 conv accumulation order, oneDNN
against XLA on the CPU); the weight round trips are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spr_pick_tpu.losses import clamped_sigmoid as jax_clamped_sigmoid
from spr_pick_tpu.models.joint import Detector as JDetector
from spr_pick_tpu.models.resnet import ResNet6 as JResNet6
from spr_pick_tpu.models.resnet import ResNet16 as JResNet16
from spr_pick_tpu.ops.nms import nms_to_host as jax_nms_to_host
from spr_pick_tpu_torch import weights
from spr_pick_tpu_torch.losses import clamped_sigmoid
from spr_pick_tpu_torch.models.joint import Detector
from spr_pick_tpu_torch.models.resnet import ResNet6, ResNet8, ResNet16
from spr_pick_tpu_torch.ops.nms import nms_to_host
from spr_pick_tpu_torch.utils.schedule import insize_from_outsize
from tests.test_torch_models import _inputs, _t, flax_variables, randomize

ATOL = 1e-5
VARIANTS = {"resnet6": (ResNet6, JResNet6), "resnet16": (ResNet16, JResNet16)}


def test_receptive_field_widths():
    assert (ResNet6.width, ResNet8.width, ResNet16.width) == (35, 63, 91)
    assert insize_from_outsize([dict(kernel_size=3, stride=2)], 4) == 9


@pytest.mark.parametrize("dense,size", [(False, 101), (True, 36)],
                         ids=["strided", "dense"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_resnet_variant_matches_flax(variant, dense, size):
    cls, jcls = VARIANTS[variant]
    net = randomize(cls(), seed=5)
    x = _inputs((2, size, size + 4, 1), seed=1)
    with torch.no_grad():
        got = net(_t(x).permute(0, 3, 1, 2), dense).permute(0, 2, 3, 1).numpy()
    want = np.asarray(jcls(dense=dense).apply(flax_variables(net),
                                              jnp.asarray(x), False))
    assert got.shape == want.shape
    if dense:
        assert got.shape[1:3] == (size, size + 4)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _assert_trees_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_resnet_variant_weights_round_trip(variant):
    """flax init -> port modules -> flax, and port -> flax -> port: exact."""
    cls, jcls = VARIANTS[variant]
    variables = jcls().init(jax.random.PRNGKey(3),
                            jnp.zeros((1, cls.width, cls.width, 1)), False)
    trainable = {"model": jax.tree_util.tree_map(np.asarray,
                                                 variables["params"])}
    static = {"model": jax.tree_util.tree_map(np.asarray,
                                              variables["batch_stats"])}
    states = weights.flax_to_state(trainable, static)
    net = cls()
    net.load_state_dict(states["model"], strict=True)
    back_t, back_s = weights.state_to_flax({"model": net.state_dict()})
    _assert_trees_equal(back_t, trainable)
    _assert_trees_equal(back_s, static)

    port = randomize(cls(), seed=9)
    sd = port.state_dict()
    again = weights.flax_to_state(*weights.state_to_flax({"model": sd}))
    assert again["model"].keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(again["model"][k], v), k


def _detectors(seed=4):
    dilated = randomize(Detector(), seed=seed)
    stitch = Detector(dense_impl="stitch").eval()
    stitch.load_state_dict(dilated.state_dict())
    return dilated, stitch


@pytest.mark.parametrize("shape", [(64, 72), (62, 66)],
                         ids=["multiple-of-4", "dilated-fallback"])
def test_stitch_detector_matches_flax_and_dilated(shape):
    dilated, stitch = _detectors()
    x = _inputs((2,) + shape + (1,), seed=2)
    with torch.no_grad():
        got = stitch(_t(x), dense=True).numpy()
        ref = dilated(_t(x), dense=True).numpy()
    want = np.asarray(JDetector(dense=True, dense_impl="stitch").apply(
        flax_variables(stitch), jnp.asarray(x), False))
    assert got.shape == want.shape == (2,) + shape + (1,)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_stitch_keeps_the_strided_crop_logit():
    """Outside dense mode the stitch detector is the strided network."""
    dilated, stitch = _detectors(seed=6)
    x = _t(_inputs((3, 64, 64, 1), seed=3))
    with torch.no_grad():
        assert torch.equal(stitch(x), dilated(x))


def test_stitch_heatmap_picks_match_jax():
    """The slice as a whole: the stitch heatmap through the port's NMS (K1's
    plain version on the CPU) picks what JAX's NMS picks on JAX's stitch
    heatmap, pick for pick."""
    dilated, stitch = _detectors(seed=7)
    with torch.no_grad():
        # Scale the classifier so the map has peaks and a low background.
        stitch.classifier.classifier.weight.mul_(8.0)
        stitch.classifier.classifier.bias.fill_(-4.0)
    x = _inputs((1, 96, 128, 1), seed=4)
    with torch.no_grad():
        hm = clamped_sigmoid(stitch(_t(x), dense=True))[0, :, :, 0]
    jlogits = JDetector(dense=True, dense_impl="stitch").apply(
        flax_variables(stitch), jnp.asarray(x), False)
    jhm = jax_clamped_sigmoid(jlogits)[0, :, :, 0]
    np.testing.assert_allclose(hm.numpy(), np.asarray(jhm), atol=ATOL, rtol=0)
    scores, coords = nms_to_host(hm, 15, threshold=0.02)
    want_scores, want_coords = jax_nms_to_host(jhm, 15, threshold=0.02)
    assert len(scores) > 3
    np.testing.assert_array_equal(coords, want_coords)
    np.testing.assert_allclose(scores, want_scores, atol=ATOL, rtol=0)


def test_unknown_dense_impl_is_refused():
    with pytest.raises(ValueError, match="dense_impl"):
        Detector(dense_impl="fold")
