"""Dense evaluation of denoise-only models, the port against the JAX
package, from the JAX initial weights: ssdn (the `JointNetwork` U-Net on
its fused route, rot4 on a square, the two-lane fold on 64x96; no detector
runs), n2c (the plain single-head U-Net on any shape) and ssdn_u_only (the
blind-spot single-head U-Net, its own rot4 forward: a rectangle is square
padded first, as the JAX package's `supports_rect_dense` demands).  The
outputs IMG_DENOISED, IMG_MU and MODEL_STD_DEV agree within 1e-5 of their
largest entry (float32).  The learnt noise s.d. starts at 0.69 (see
tests/test_torch_denoise_step_rgb.py): the PME divides by sigma_x +
sigma_n, and at the init's sigma_n (3.6e-4) it magnifies a rounding-level
difference of A a thousandfold.

The Picker on a `.wt` of those weights written by the port: `denoise`
equals the JAX Picker's within 1e-5 on a 50x70 micrograph (reflect pad to
64x96; square 96^2 for ssdn_u_only), `pick` raises "no detector head" and
`process_table` gives no picks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spr_pick_tpu.api import Picker as JPicker
from spr_pick_tpu.denoiser import Denoiser as JDenoiser
from spr_pick_tpu.params import PipelineOutput as JPO
from spr_pick_tpu_torch.api import Picker
from spr_pick_tpu_torch.data import mrc
from spr_pick_tpu_torch.data.micrograph import pad_to_multiple
from spr_pick_tpu_torch.denoiser import Denoiser
from spr_pick_tpu_torch.params import PipelineOutput
from spr_pick_tpu_torch.steps import eval_step
from spr_pick_tpu_torch.utils import checkpoint as ckpt
from tests.test_torch_denoise_step import cfgs, jax_init

RTOL = 1e-5
SIGMA = 4.0
MODELS = {"ssdn": "const", "n2c": None, "ssdn_u_only": None}


def assert_close(got, want, name):
    want = np.asarray(want)
    assert got.shape == want.shape, name
    atol = RTOL * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=name)


@pytest.fixture(scope="module", params=list(MODELS))
def model(request):
    algorithm = request.param
    c, j = cfgs(algorithm, MODELS[algorithm])
    jden = JDenoiser(j, mode="denoise")
    trainable, static = jax_init(
        jden, 64, SIGMA if algorithm == "ssdn" else None)
    den = Denoiser(c, mode="denoise", device="cpu")
    den.load_variables(trainable, static)
    return algorithm, c, jden, den, trainable, static


@pytest.mark.parametrize("shape", [(64, 64), (64, 96)], ids=["square", "rect"])
def test_dense_eval_matches_jax(model, shape):
    algorithm, _, jden, den, trainable, static = model
    assert den.supports_rect_dense == jden.supports_rect_dense \
        == (algorithm != "ssdn_u_only")
    x = np.random.RandomState(4).rand(*shape).astype(np.float32)
    if not den.supports_rect_dense:
        x, _ = pad_to_multiple(x, 32, square=True)
    x = x[None, :, :, None]

    @jax.jit
    def jax_eval(inp):
        return jden.run_pipeline(trainable, static, {"inp": inp},
                                 jax.random.PRNGKey(0), train=False,
                                 dense=True)[1][0]

    want = jax_eval(jnp.asarray(x))
    got = eval_step(den, {"inp": torch.from_numpy(x)})
    assert PipelineOutput.DETECT not in got
    keys = [PipelineOutput.IMG_DENOISED]
    if algorithm == "ssdn":
        keys += [PipelineOutput.IMG_MU, PipelineOutput.MODEL_STD_DEV]
    for k in keys:
        assert_close(got[k].numpy(), want[JPO(k.value)], str(k))


def test_picker_denoise_matches_jax_picker(model, tmp_path):
    algorithm, c, _, _, trainable, static = model
    wt = str(tmp_path / f"{algorithm}.wt")
    ckpt.save_weights(wt, trainable, static, c, "denoise")
    mic = str(tmp_path / "mic.mrc")
    mrc.write(mic, np.random.RandomState(5).rand(50, 70).astype(np.float32))
    picker = Picker(wt, device="cpu")
    got = picker.denoise(mic)
    want = JPicker(wt).denoise(mic)
    assert got.shape == (50, 70)
    assert_close(got, want, "denoise")
    with pytest.raises(ValueError, match="no detector head"):
        picker.pick(mic)
    picks, den = picker.process_table(mic)
    assert picks is None
    np.testing.assert_array_equal(den, got)
