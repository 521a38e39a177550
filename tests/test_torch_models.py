"""The PyTorch port's models against the flax modules on the same weights.

Weights come from the port's seeded init with every bias and BatchNorm
statistic randomised (so the key mapping of `weights.py` is exercised),
converted to the flax tree with `weights.state_to_flax`, and applied by
both packages to the same numpy input in float32.  Tolerance: atol 1e-5,
float32 conv accumulation order (oneDNN vs XLA on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spr_pick_tpu.models import blindspot as jbs
from spr_pick_tpu.models.joint import Detector as JDetector
from spr_pick_tpu.models.joint import JointNetwork as JJointNetwork
from spr_pick_tpu.models.resnet import ResNet8 as JResNet8
from spr_pick_tpu.models.unet import BlindspotUNet as JBlindspotUNet
from spr_pick_tpu_torch import weights
from spr_pick_tpu_torch.models import blindspot as tbs
from spr_pick_tpu_torch.models import resnet as tresnet
from spr_pick_tpu_torch.models.joint import Detector, JointNetwork
from spr_pick_tpu_torch.models.resnet import ResNet8
from spr_pick_tpu_torch.models.unet import BlindspotUNet

ATOL = 1e-5


def randomize(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Seeded init, then random biases and BatchNorm parameters/statistics."""
    g = torch.Generator().manual_seed(seed)
    if hasattr(module, "reset_parameters"):
        module.reset_parameters(g)
    else:
        tresnet.reset_parameters(module, g)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            if not t.is_floating_point() or t.ndim != 1:
                continue
            r = torch.randn(t.shape, generator=g)
            if name.endswith("running_var"):
                t.copy_(0.5 + torch.rand(t.shape, generator=g))
            elif name.endswith("weight"):  # BatchNorm scale
                t.copy_(1.0 + 0.1 * r)
            else:
                t.copy_(0.1 * r)
    return module.eval()


def flax_variables(module: torch.nn.Module) -> dict:
    """{"params": ..., "batch_stats": ...?} for flax ``apply``."""
    trainable, static = weights.state_to_flax({"model": module.state_dict()})
    variables = {"params": trainable["model"]}
    if "model" in static:
        variables["batch_stats"] = static["model"]
    return variables


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(shape, seed=0) -> np.ndarray:
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_rotations_and_shift_match_jax_exactly():
    x = _inputs((2, 6, 6, 3))
    for angle in (0, 90, 180, 270):
        np.testing.assert_array_equal(
            tbs.rotate(_t(x), angle).numpy(),
            np.asarray(jbs.rotate(jnp.asarray(x), angle)),
        )
    np.testing.assert_array_equal(
        tbs.shift_down(_t(x), 1).numpy(),
        np.asarray(jbs.shift_down(jnp.asarray(x), 1)),
    )
    np.testing.assert_array_equal(
        tbs.rot4_stack(_t(x)).numpy(), np.asarray(jbs.rot4_stack(jnp.asarray(x)))
    )
    y = _inputs((8, 6, 6, 3), seed=1)
    np.testing.assert_array_equal(
        tbs.rot4_unstack(_t(y)).numpy(),
        np.asarray(jbs.rot4_unstack(jnp.asarray(y))),
    )


@pytest.mark.parametrize(
    "blindspot,levels,out_channels",
    [(True, 5, 2), (False, 3, 1)],
    ids=["blindspot-levels5", "plain-levels3"],
)
def test_blindspot_unet_matches_flax(blindspot, levels, out_channels):
    net = randomize(BlindspotUNet(1, out_channels, blindspot=blindspot,
                                  levels=levels), seed=levels)
    x = _inputs((1, 64, 64, 1))
    with torch.no_grad():
        got = net(_t(x)).numpy()
    jnet = JBlindspotUNet(in_channels=1, out_channels=out_channels,
                          blindspot=blindspot, levels=levels)
    want = np.asarray(jnet.apply(flax_variables(net), jnp.asarray(x)))
    assert got.shape == want.shape == (1, 64, 64, out_channels)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("dense,size", [(False, 79), (True, 40)],
                         ids=["strided", "dense"])
def test_resnet8_matches_flax(dense, size):
    net = randomize(ResNet8(), seed=3)
    x = _inputs((2, size, size, 1))
    with torch.no_grad():
        got = net(_t(x).permute(0, 3, 1, 2), dense).permute(0, 2, 3, 1).numpy()
    want = np.asarray(JResNet8(dense=dense).apply(
        flax_variables(net), jnp.asarray(x), False
    ))
    assert got.shape == want.shape
    if dense:
        assert got.shape[1:3] == (size, size)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("dense", [False, True], ids=["strided", "dense"])
def test_detector_matches_flax(dense):
    net = randomize(Detector(), seed=4)
    x = _inputs((2, 72, 72, 1))
    with torch.no_grad():
        got = net(_t(x), dense).numpy()
    want = np.asarray(JDetector(dense=dense).apply(
        flax_variables(net), jnp.asarray(x), False
    ))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def zero_sigma_head(net: JointNetwork) -> JointNetwork:
    """Zero the A half of out_conv so z == mu: the sample noise drops out."""
    with torch.no_grad():
        net.denoise_branch.out_conv.conv.weight[1:] = 0.0
        net.denoise_branch.out_conv.conv.bias[1:] = 0.0
    return net


def test_joint_network_dense_matches_flax():
    net = zero_sigma_head(randomize(JointNetwork(), seed=5))
    x = _inputs((1, 64, 64, 1))
    with torch.no_grad():
        stats, detect = net(_t(x), dense=True,
                            generator=torch.Generator().manual_seed(0))
    jstats, jdetect = JJointNetwork(dense=True).apply(
        flax_variables(net), jnp.asarray(x), False,
        rngs={"sample": jax.random.PRNGKey(0)},
    )
    assert detect.shape == (1, 64, 64, 1)
    np.testing.assert_allclose(stats.numpy(), np.asarray(jstats), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(detect.numpy(), np.asarray(jdetect), atol=ATOL,
                               rtol=0)


def test_blindspot_property():
    """An output pixel does not depend on its own input pixel."""
    net = randomize(BlindspotUNet(1, 2, blindspot=True, levels=3), seed=6)
    x = _t(_inputs((1, 32, 32, 1))).requires_grad_(True)
    r, c = 13, 17
    net(x)[0, r, c, :].sum().backward()
    g = x.grad[0, :, :, 0]
    assert float(g[r, c]) == 0.0
    assert float(g.abs().sum()) > 0.0
