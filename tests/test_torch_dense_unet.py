"""The port's dense blind-spot U-Net forward against the JAX one.

Both run in float32 on the same weights and input; atol 1e-5 (float32
conv accumulation order).  The square input takes the rot4 fold, the
rectangular one the two-lane fold, in both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spr_pick_tpu.ops.dense_unet import dense_blindspot_unet as jax_dense
from spr_pick_tpu_torch.models.unet import BlindspotUNet
from spr_pick_tpu_torch.ops.dense_unet import dense_blindspot_unet
from tests.test_torch_models import flax_variables, randomize

ATOL = 1e-5


@pytest.fixture(scope="module")
def unet():
    return randomize(BlindspotUNet(1, 2, blindspot=True, levels=5), seed=11)


@pytest.mark.parametrize("shape", [(64, 64), (64, 96)], ids=["square", "rect"])
def test_dense_unet_matches_jax(unet, shape):
    x = np.random.RandomState(0).randn(1, *shape, 1).astype(np.float32)
    with torch.no_grad():
        got = dense_blindspot_unet(unet, torch.from_numpy(x)).numpy()
    want = np.asarray(jax_dense(flax_variables(unet)["params"],
                                jnp.asarray(x), out_channels=2,
                                cdtype=jnp.float32))
    assert got.shape == want.shape == (1, *shape, 2)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_rect_fold_equals_rot4_on_square(unet):
    x = torch.from_numpy(
        np.random.RandomState(1).randn(2, 64, 64, 1).astype(np.float32)
    )
    with torch.no_grad():
        rot4 = dense_blindspot_unet(unet, x)
        rect = dense_blindspot_unet(unet, x, force_rect=True)
        module = unet(x)
    np.testing.assert_allclose(rect.numpy(), rot4.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(module.numpy(), rot4.numpy(), atol=ATOL, rtol=0)
