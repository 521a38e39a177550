"""One denoise-only training step of the mse pipelines, the port against
the JAX package, on the single-head U-Net: n2c, n2n (plain MSE against
the clean image or a second noisy copy), n2v (masked MSE on the UPS
pixels; non-blind-spot) and ssdn_u_only (MSE against its own input,
blind-spot, rot4 fold).  The batch is the host plane's `prepare_batch`
(bit-equal to the JAX package's, tests/test_torch_denoise_data.py) on
32^2 crops; the pipelines draw nothing.  Helpers and tolerances are those
of `tests/test_torch_denoise_step.py`; the model has no BatchNorm.
"""

import numpy as np
import pytest

from spr_pick_tpu_torch.data.noisy import prepare_batch
from spr_pick_tpu_torch.params import NoiseAlgorithm, PipelineOutput
from tests.test_torch_denoise_step import (B, check_adam, check_gradients,
                                           check_losses, one_step)


@pytest.fixture(scope="module", params=["n2c", "n2n", "n2v", "ssdn_u_only"])
def mse_step(request):
    rng = np.random.RandomState(3)
    clean = rng.rand(B, 32, 32).astype(np.float32)
    batch = prepare_batch(clean, NoiseAlgorithm(request.param), "gauss25",
                          rng)
    return request.param, one_step(request.param, batch)


def test_loss_terms_match_jax(mse_step):
    algorithm, r = mse_step
    check_losses(r, (PipelineOutput.IMG_DENOISED,))
    assert set(r["port"]["outs"]) == {PipelineOutput.IMG_DENOISED,
                                      PipelineOutput.LOSS}


def test_gradients_match_jax(mse_step):
    _, r = mse_step
    check_gradients(r)
    assert not r["port"]["no_grad"]


def test_params_after_adam_match_optax(mse_step):
    _, r = mse_step
    check_adam(r)
