"""One denoise-only ssdn training step on three input channels, the port
against the JAX package: A diagonal (out_channels 6) and full upper
triangular (out_channels 9, sigma_x = A^T A through `full_cov_nll_pme`).
The detector takes the sample's three channels (its input BatchNorm and
ResNet8's first conv, as flax infers them).  Same weights, crops and
sample noise as `tests/test_torch_denoise_step.py`, whose helpers and
tolerances this file uses.  The learnt noise s.d. starts at
softplus(4 - 4) + 1e-3 = 0.69 instead of the init's 0.019: at 0.019 the
per-pixel 3x3 inverse of sigma_x + sigma_n amplifies rounding so far that
one U-Net leaf's gradient (dec0_conv0's bias) differed by 3.7e-3 of its
largest entry, past the 3e-3 of
`tests/test_torch_train_step.py`.
"""

import pytest

from spr_pick_tpu_torch.params import PipelineOutput
from tests.test_torch_denoise_step import (check_adam, check_gradients,
                                           check_losses, check_running_stats,
                                           crops, one_step)

SIGMA = 4.0  # raw learnt sigma: softplus(SIGMA - 4) + 1e-3 = 0.694


@pytest.fixture(scope="module", params=[True, False], ids=["diag", "full"])
def rgb_step(request):
    inp, eps = crops(64, channels=3, seed=2)
    return one_step("ssdn", {"inp": inp}, noise_value="const", channels=3,
                    diagonal=request.param, eps=eps, sigma=SIGMA)


def test_loss_terms_match_jax(rgb_step):
    check_losses(rgb_step, (PipelineOutput.IMG_MU,))
    assert rgb_step["port"]["outs"][PipelineOutput.IMG_MU].shape[-1] == 3


def test_gradients_match_jax(rgb_step):
    check_gradients(rgb_step, zero_prefix="/model/detector/")


def test_detector_running_stats_move_as_in_jax(rgb_step):
    check_running_stats(rgb_step)


def test_params_after_adam_match_optax(rgb_step):
    check_adam(rgb_step)
