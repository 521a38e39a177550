"""The slice end to end with a `var` checkpoint: the sigma U-Net (plain,
3 levels) sets the noise estimate that the denoised image depends on.
Same set-up and tolerances as tests/test_torch_api.py."""

import numpy as np
import pytest

from spr_pick_tpu.api import Picker as JPicker
from spr_pick_tpu.params import NoiseValue as JNoiseValue
from spr_pick_tpu_torch.api import Picker
from tests.test_torch_api import ATOL, assert_same_picks, make_jax_wt


@pytest.fixture(scope="module")
def pickers(tmp_path_factory):
    wt = make_jax_wt(str(tmp_path_factory.mktemp("api_var") / "var.wt"),
                     JNoiseValue.UNKNOWN_VARIABLE)
    return JPicker(wt, border=0), Picker(wt, border=0, device="cpu")


@pytest.mark.parametrize("shape", [(128, 128), (96, 128)],
                         ids=["square", "rect"])
def test_var_pick_and_denoise_match_jax(pickers, shape):
    jax_picker, port = pickers
    img = np.random.RandomState(1).rand(*shape).astype(np.float32)
    picks, den = port.process(img)
    assert_same_picks(picks, jax_picker.pick(img))
    want = jax_picker.denoise(img)
    assert den.shape == want.shape == shape
    np.testing.assert_allclose(den, want, atol=ATOL, rtol=0)
