"""One denoise-only training step of the port against the JAX package:
ssdn on one channel with the noise s.d. constant (learnt scalar), variable
(the sigma U-Net) and known (from the batch), gauss and poisson.

Both packages start from the JAX package's own initial weights
(`Denoiser.init_variables`, carried across by `Denoiser.load_variables`)
and see the same float32 crops (B = 2, 64^2: the detector's receptive
field is 63 px) and the same sample noise: the JAX step's
``jax.random.normal`` is replaced inside the traced step by a seeded array
(the JAX package is unchanged) that the port receives as ``eps``.  The
JAX side is `run_pipeline(train=True)` under `jax.value_and_grad`, the
port's is `run_pipeline(batch, True)` under autograd.

Checked, with `tests/test_torch_train_step.py`'s tolerances: the loss
terms within 1e-5 relative (the mu map within 1e-5 of its largest entry;
the PME map is held by `tests/test_torch_denoise_eval.py`, where the
noise s.d. keeps it well conditioned); the gradient of every trainable
leaf within 3e-3 of the leaf's largest entry (max-pool windows whose
entries tie up to rounding route single gradient entries by rounding),
and exactly zero
for the detector, which the loss does not reach (the port leaves its
``grad`` None, which Adam counts as zero); the detector's BatchNorm running
statistics, which the step still moves, within 1e-6; and the parameters
after one Adam update from the same gradients within 1e-6 of optax's.
`tests/test_torch_denoise_step_rgb.py` and `..._step_mse.py` run the
3-channel ssdn and the mse pipelines through the same helpers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from spr_pick_tpu import cfg as jcfg_mod
from spr_pick_tpu.denoiser import Denoiser as JDenoiser
from spr_pick_tpu.params import ConfigValue as JCV
from spr_pick_tpu.params import NoiseAlgorithm as JNA
from spr_pick_tpu.params import NoiseValue as JNV
from spr_pick_tpu.params import PipelineOutput as JPO
from spr_pick_tpu_torch import cfg as cfg_mod
from spr_pick_tpu_torch import weights
from spr_pick_tpu_torch.denoiser import Denoiser
from spr_pick_tpu_torch.params import (ConfigValue, NoiseAlgorithm,
                                       NoiseValue, PipelineOutput)
from spr_pick_tpu_torch.steps import make_optimizer

B = 2
RTOL_LOSS = 1e-5
ATOL_REL = 3e-3
ATOL_BN = 1e-6
ATOL_ADAM = 1e-6
LR = 1e-4


def cfgs(algorithm, noise_value=None, channels=1, diagonal=False,
         style="gauss25"):
    out = []
    for mod, cv, na, nv in ((cfg_mod, ConfigValue, NoiseAlgorithm,
                             NoiseValue), (jcfg_mod, JCV, JNA, JNV)):
        c = mod.base()
        c[cv.ALGORITHM] = na(algorithm)
        c[cv.NOISE_STYLE] = style
        if noise_value is not None:
            c[cv.NOISE_VALUE] = nv(noise_value)
        c[cv.COMPUTE_DTYPE] = "f32"
        c[cv.IMAGE_CHANNELS] = channels
        c[cv.DIAGONAL_COVARIANCE] = diagonal
        out.append(c)
    return out


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def jax_swapped_normal(eps):
    """A ``jax.random.normal`` stand-in that hands out ``eps``."""

    def fixed(key, shape, dtype=jnp.float32):
        assert tuple(shape) == eps.shape, shape
        return jnp.asarray(eps, dtype)

    return fixed


def jax_init(jden, patch, sigma=None):
    """The JAX package's initial (trainable, static) numpy trees; ``sigma``
    sets the learnt constant's raw value (before the softplus remap)."""
    trainable, static = JDenoiser.split_trainable(
        jden.init_variables(seed=0, patch=patch))
    trainable = jax.tree_util.tree_map(np.array, trainable)
    static = jax.tree_util.tree_map(np.asarray, static)
    if sigma is not None:
        trainable["l_params"]["estimated_sigma"][...] = sigma
    return trainable, static


def one_step(algorithm, batch, noise_value=None, channels=1, diagonal=False,
             eps=None, sigma=None, style="gauss25", head_bias=None):
    """Both packages' step from the JAX initial weights on ``batch`` (numpy,
    NHWC); ``eps`` replaces the JAX sample noise; ``sigma``: `jax_init`;
    ``style`` the noise style; ``head_bias`` = (mu, A) the biases of the
    output conv.
    Returns a dict of both sides' results."""
    c, j = cfgs(algorithm, noise_value, channels, diagonal, style)
    jden = JDenoiser(j, mode="denoise")
    trainable, static = jax_init(jden, batch["inp"].shape[1], sigma)
    if head_bias is not None:
        bias = trainable["model"]["denoise_branch"]["out_conv"]["conv"]["bias"]
        bias[0], bias[1:] = head_bias
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(tr):
        normal = jax.random.normal
        if eps is not None:
            jax.random.normal = jax_swapped_normal(eps)
        try:
            return jden.run_pipeline(tr, static, jbatch,
                                     jax.random.PRNGKey(0), train=True)
        finally:
            jax.random.normal = normal

    (loss, (outs, bn)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(trainable)

    den = Denoiser(c, mode="denoise", device="cpu")
    den.load_variables(trainable, static)
    den.train()
    draws = {} if eps is None else {"eps": torch.from_numpy(eps)}
    t_loss, t_outs = den.run_pipeline(
        {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in batch.items()}, True, **draws)
    t_loss.backward()
    named = den.named_trainable()
    no_grad = {k for k, v in leaves(weights.named_to_flax(
        (g, k, torch.full_like(t, float(t.grad is None)))
        for g, k, t in named)) if np.all(v == 1)}
    t_grads = weights.named_to_flax(
        (g, k, t.grad if t.grad is not None else torch.zeros_like(t))
        for g, k, t in named)
    t_static = den.variables()[1]

    # One Adam update in both packages from the JAX gradients.
    opt = make_optimizer(den)
    with torch.no_grad():
        for t, g in zip(opt.params, weights.flax_to_named(grads, named)):
            t.grad = g
    opt.step(LR)
    tx = optax.scale_by_adam(b1=0.9, b2=0.99, eps=1e-8)
    updates, _ = tx.update(grads, tx.init(trainable), trainable)
    after = jax.tree_util.tree_map(lambda p, u: p - LR * u, trainable,
                                   updates)
    return dict(
        jax=dict(loss=float(loss), outs=outs, bn=bn, grads=grads,
                 after=after, static=static),
        port=dict(loss=t_loss.item(), outs=t_outs, grads=t_grads,
                  static=t_static, after=den.variables()[0],
                  no_grad=no_grad))


def check_losses(r, maps=()):
    """The mean and per-item losses within RTOL_LOSS relative; output maps
    within RTOL_LOSS of their largest entry (conv accumulation order)."""
    np.testing.assert_allclose(r["port"]["loss"], r["jax"]["loss"],
                               rtol=RTOL_LOSS)
    for k in (PipelineOutput.LOSS,) + tuple(maps):
        want = np.asarray(r["jax"]["outs"][JPO(k.value)])
        got = r["port"]["outs"][k].detach().numpy()
        assert got.shape == want.shape, k
        atol = 0 if k == PipelineOutput.LOSS else (
            RTOL_LOSS * float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=RTOL_LOSS, atol=atol,
                                   err_msg=str(k))


def check_gradients(r, zero_prefix=None):
    """Every leaf within ATOL_REL of its largest entry; leaves whose JAX
    gradient is exactly zero (the detector, the loss does not reach it)
    have no gradient in the port."""
    want = dict(leaves(r["jax"]["grads"]))
    got = dict(leaves(r["port"]["grads"]))
    assert got.keys() == want.keys()
    zero = {k for k, w in want.items() if not np.any(w)}
    if zero_prefix is not None:
        assert zero == {k for k in want if k.startswith(zero_prefix)}
        assert zero <= r["port"]["no_grad"]
    for name, w in want.items():
        if name in zero:
            assert not np.any(got[name]), name
            continue
        atol = ATOL_REL * float(np.abs(w).max())
        np.testing.assert_allclose(got[name], w, rtol=0, atol=atol,
                                   err_msg=name)


def check_running_stats(r):
    """The step's new BatchNorm statistics (the detector's) against flax's
    ``mutable=["batch_stats"]`` update, and that they moved."""
    want = dict(leaves(r["jax"]["bn"]))
    got = dict(leaves(r["port"]["static"]["model"]))
    before = dict(leaves(r["jax"]["static"]["model"]))
    assert got.keys() == want.keys() and len(got) == 18
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0, atol=ATOL_BN,
                                   err_msg=name)
    assert any(np.any(want[k] != before[k]) for k in want)


def check_adam(r):
    want = dict(leaves(r["jax"]["after"]))
    got = dict(leaves(r["port"]["after"]))
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0, atol=ATOL_ADAM,
                                   err_msg=name)


def crops(patch, channels=1, seed=1):
    rng = np.random.RandomState(seed)
    inp = rng.rand(B, patch, patch, channels).astype(np.float32)
    eps = rng.randn(B, patch, patch, channels).astype(np.float32)
    return inp, eps


# id: (noise value, noise style, what the batch adds).  The poisson
# styles take `_noise_std`'s poisson branches: sqrt(mu * s.d.) estimated,
# sqrt(mu / lambda) known.  Their output conv starts at bias (2, 1) (mu,
# A): at the initial weights mu ~ 0, where sqrt(max(mu, 1e-3) * s.d.)
# turns float32 rounding of mu into a loss move of 1.5e-3 a one-ulp nudge
# of the U-Net's weights; at mu ~ 2 it is 7.4e-6.
SSDN = {"const": ("const", "gauss25", {}), "var": ("var", "gauss25", {}),
        "known": ("known", "gauss25", {"noise_std": np.array(
            [0.1, 0.2], np.float32).reshape(B, 1, 1, 1)}),
        "const-poisson": ("const", "poisson30", {}),
        "known-poisson": ("known", "poisson10_50", {"noise_std": np.array(
            [12.0, 41.0], np.float32).reshape(B, 1, 1, 1)})}


@pytest.fixture(scope="module", params=list(SSDN))
def ssdn_step(request):
    noise_value, style, extra = SSDN[request.param]
    inp, eps = crops(64)
    batch = {"inp": inp, **extra}
    return one_step("ssdn", batch, noise_value=noise_value, eps=eps,
                    style=style,
                    head_bias=(2.0, 1.0) if style.startswith("poisson")
                    else None)


def test_loss_terms_match_jax(ssdn_step):
    check_losses(ssdn_step, (PipelineOutput.IMG_MU,))


def test_gradients_match_jax(ssdn_step):
    check_gradients(ssdn_step, zero_prefix="/model/detector/")


def test_detector_running_stats_move_as_in_jax(ssdn_step):
    check_running_stats(ssdn_step)


def test_params_after_adam_match_optax(ssdn_step):
    check_adam(ssdn_step)
