"""One joint training step of the port against the JAX package.

The JAX `Denoiser.joint_pipeline(train=True)` under `jax.value_and_grad`
and the port's `Denoiser.joint_train_pipeline` under autograd see the same
float32 weights (the port's seeded init with randomised biases and
BatchNorm statistics), the same 64^2 crops and PU labels (labeled,
unlabeled and soft), and the same draws: the JAX sample noise is replaced
by seeded numpy arrays (``jax.random.normal`` wrapped inside the traced
step; the JAX package is unchanged) that the port receives as ``eps`` /
``eps2``, and the flip draw is the JAX step's own ``uniform`` of the key's
second split, handed to the port as ``flip_p``.  Keys 0 and 2 flip along W
and H.  Both flip-TTA forms run: folded (one 2B forward, one BatchNorm
update) and sequential (two forwards, the second BatchNorm update starting
from the first), at batch 3.

Tolerances (float32; conv accumulation order differs, oneDNN against XLA):
loss terms rtol 1e-5, except the flip-consistency term, a mean of squared
differences of two detector outputs (~0.04 apart), whose relative error is
the detector's over that difference: 1e-6 absolute (ATOL_AUG); the new
BatchNorm running statistics within 1e-6;
the gradient of every trainable leaf, the learnable constant sigma
included, within 3e-3 of the leaf's largest gradient (ATOL_REL).  That
gradient tolerance is set by the U-Net's max pools, not by either package:
where a 2x2 window's entries tie up to rounding (rows that only padding
reaches), rounding decides which entry takes the gradient, so a
rounding-level change of the forward moves single gradient entries (and,
through the detector's ReLUs, BatchNorm leaves); the largest difference
this test reads is 1.3e-3 of a leaf's largest.  The input
BatchNorm's scale and bias have an exact gradient of zero (the BatchNorm
after the detector's first conv cancels any affine change of its input),
so they are held to 1e-5 absolute.  Beside the
step: `Detector` in train mode against flax ``mutable=["batch_stats"]``
and the BatchNorm running update against flax's (biased variance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spr_pick_tpu import cfg as jcfg_mod
from spr_pick_tpu.denoiser import Denoiser as JDenoiser
from spr_pick_tpu.models.joint import Detector as JDetector
from spr_pick_tpu.params import ConfigValue as JCV
from spr_pick_tpu.params import NoiseAlgorithm as JNA
from spr_pick_tpu.params import NoiseValue as JNV
from spr_pick_tpu.params import PipelineOutput as JPO
from spr_pick_tpu_torch import cfg as cfg_mod
from spr_pick_tpu_torch import weights
from spr_pick_tpu_torch.denoiser import Denoiser
from spr_pick_tpu_torch.models.joint import Detector
from spr_pick_tpu_torch.params import ConfigValue, NoiseAlgorithm, NoiseValue
from spr_pick_tpu_torch.params import PipelineOutput
from tests.test_torch_models import flax_variables, randomize

B = 3
PATCH = 64
ALPHA, TAU = 0.75, 0.05
RTOL_LOSS = 1e-5
ATOL_REL = 3e-3
ATOL_ZERO_GRAD = 1e-5
ATOL_AUG = 1e-6
ATOL_BN = 1e-6
TARGET = np.array([0.9, -1.0, 0.0], np.float32)
KEYS = {"w_flip": 0, "h_flip": 2}


def cfgs():
    c = cfg_mod.base()
    c[ConfigValue.ALGORITHM] = NoiseAlgorithm.SELFSUPERVISED_DENOISING
    c[ConfigValue.NOISE_STYLE] = "gauss"
    c[ConfigValue.NOISE_VALUE] = NoiseValue.UNKNOWN_CONSTANT
    c[ConfigValue.COMPUTE_DTYPE] = "f32"
    j = jcfg_mod.base()
    j[JCV.ALGORITHM] = JNA.SELFSUPERVISED_DENOISING
    j[JCV.NOISE_STYLE] = "gauss"
    j[JCV.NOISE_VALUE] = JNV.UNKNOWN_CONSTANT
    j[JCV.COMPUTE_DTYPE] = "f32"
    return c, j


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def flip_p(key: int) -> float:
    """The JAX step's flip draw: uniform of the second of three splits."""
    _, k_flip, _ = jax.random.split(jax.random.PRNGKey(key), 3)
    return float(jax.random.uniform(k_flip))


def port_denoiser(c, fold: bool) -> Denoiser:
    den = Denoiser(c, device="cpu", fold_tta=fold)
    randomize(den.model, seed=5)
    with torch.no_grad():
        den.l_params["estimated_sigma"].fill_(0.3)
    return den.train()


@pytest.fixture(scope="module", params=[True, False], ids=["fold", "seq"])
def step(request):
    """Both packages' step for one flip-TTA form, at both flip keys."""
    fold = request.param
    c, j = cfgs()
    den = port_denoiser(c, fold)
    trainable, static = den.variables()
    rng = np.random.RandomState(1)
    inp = rng.rand(B, PATCH, PATCH, 1).astype(np.float32)
    n_eps = [2 * B] if fold else [B, B]
    eps = [rng.randn(n, PATCH, PATCH, 1).astype(np.float32) for n in n_eps]

    jden = JDenoiser(j, mode="joint", fold_tta=fold)

    def loss_fn(tr, key):
        queue = list(eps)
        normal = jax.random.normal

        def fixed(k, shape, dtype=jnp.float32):
            got = queue.pop(0)
            assert got.shape == tuple(shape)
            return jnp.asarray(got, dtype)

        jax.random.normal = fixed
        try:
            loss, (outs, bn) = jden.joint_pipeline(
                tr, static, {"inp": jnp.asarray(inp),
                             "target": jnp.asarray(TARGET)},
                key, ALPHA, TAU, train=True)
        finally:
            jax.random.normal = normal
        return loss, (outs, bn)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    results = {}
    for name, key in KEYS.items():
        (loss, (outs, bn)), grads = grad_fn(trainable,
                                           jax.random.PRNGKey(key))
        den_k = port_denoiser(c, fold)
        den_k.load_variables(trainable, static)
        draws = {"eps": torch.from_numpy(eps[0]),
                 "flip_p": torch.tensor(flip_p(key))}
        if not fold:
            draws["eps2"] = torch.from_numpy(eps[1])
        t_loss, t_outs = den_k.joint_train_pipeline(
            {"inp": torch.from_numpy(inp), "target": torch.from_numpy(TARGET)},
            ALPHA, TAU, **draws)
        t_loss.backward()
        t_grads = weights.named_to_flax(
            (g, k, t.grad) for g, k, t in den_k.named_trainable())
        results[name] = dict(
            jax=(float(loss), outs, bn, grads), port=(t_loss, t_outs, t_grads),
            port_static=den_k.variables()[1]["model"])
    return results


def test_flip_keys_cover_both_axes():
    assert flip_p(KEYS["w_flip"]) <= 0.5 < flip_p(KEYS["h_flip"])


@pytest.mark.parametrize("key", list(KEYS))
def test_loss_terms_match_jax(step, key):
    r = step[key]
    loss, outs, _, _ = r["jax"]
    t_loss, t_outs, _ = r["port"]
    np.testing.assert_allclose(t_loss.item(), loss, rtol=RTOL_LOSS)
    for tk, jk in ((PipelineOutput.LOSS, JPO.LOSS),
                   (PipelineOutput.DENOISE_LOSS, JPO.DENOISE_LOSS),
                   (PipelineOutput.DETECT_LOSS, JPO.DETECT_LOSS),
                   (PipelineOutput.DETECT, JPO.DETECT)):
        np.testing.assert_allclose(t_outs[tk].detach().numpy(),
                                   np.asarray(outs[jk]), rtol=RTOL_LOSS,
                                   err_msg=str(tk))
    aug = t_outs[PipelineOutput.AUG_LOSS].item()
    np.testing.assert_allclose(aug, float(outs[JPO.AUG_LOSS]), rtol=0,
                               atol=ATOL_AUG)
    assert aug > 10 * ATOL_AUG


@pytest.mark.parametrize("key", list(KEYS))
def test_gradients_match_jax(step, key):
    r = step[key]
    want = dict(leaves(r["jax"][3]))
    got = dict(leaves(r["port"][2]))
    assert got.keys() == want.keys()
    assert "/l_params/estimated_sigma" in got
    for name, w in want.items():
        if "/input_bn/" in name:
            atol = ATOL_ZERO_GRAD
        else:
            atol = ATOL_REL * float(np.abs(w).max())
            assert atol > 0, name
        np.testing.assert_allclose(got[name], w, rtol=0, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("key", list(KEYS))
def test_batchnorm_running_stats_match_jax(step, key):
    r = step[key]
    want = dict(leaves(r["jax"][2]))
    got = dict(leaves(r["port_static"]))
    assert got.keys() == want.keys() and len(got) == 18
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0, atol=ATOL_BN,
                                   err_msg=name)


def test_detector_train_mode_matches_flax():
    """Output and new running statistics of the strided detector in train
    mode against flax ``mutable=["batch_stats"]``, at batch 16 (ResNet8's
    last layer normalises over 16 values a channel, where an unbiased
    variance would be 16/15 too large)."""
    det = randomize(Detector(), seed=3).train()
    variables = flax_variables(det)
    x = np.random.RandomState(4).randn(16, 64, 64, 1).astype(np.float32)
    want, updates = JDetector(dense=False).apply(
        variables, jnp.asarray(x), True, mutable=["batch_stats"])
    got = det(torch.from_numpy(x), dense=False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-4)
    static = weights.state_to_flax({"model": det.state_dict()})[1]["model"]
    for (name, g), (_, w) in zip(leaves(static),
                                 leaves(updates["batch_stats"])):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL_BN, err_msg=name)


def test_eval_mode_uses_running_stats_and_updates_nothing():
    det = randomize(Detector(), seed=3)
    before = {k: v.clone() for k, v in det.state_dict().items()}
    x = torch.from_numpy(
        np.random.RandomState(4).randn(2, 64, 64, 1).astype(np.float32))
    with torch.no_grad():
        det.eval()(x)
    for k, v in det.state_dict().items():
        assert torch.equal(v, before[k]), k
