"""The port's training losses, Adam and LR schedule against the JAX package.

Every loss of `spr_pick_tpu/losses.py:106-321` (binom_logpmf, bce, pu_loss,
modified_pu_loss, focal_loss, pu_focal_loss, js_div_loss_2d) gets the same
seeded float32 inputs in both packages; values are held to rtol 1e-5 and
the gradient with respect to the prediction (``jax.grad`` against autograd)
to rtol 1e-5 with an absolute floor of 1e-7 of the gradient's largest
entry.  The PU cases cover mixed labels, all labeled, all unlabeled (empty
strata of the GE penalty's softmax) and soft labels; with the entropy
penalty (0 in training) and no unlabeled entry, q_var is 0 and both
packages give a -inf loss and NaN gradients, which must match.  Adam: the same three
gradients into ``optax.scale_by_adam`` with the LR applied outside, as the
JAX train step does, and into the port's `ScaleByAdam`: updates and
moments and parameters within rtol 1e-6, the parameters starting at zero
so that they hold the sum of the updates without cancellation.  The LR schedule is compared at the
trainer's call site, where ramp-down and ramp-up are swapped.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from spr_pick_tpu import losses as jlosses
from spr_pick_tpu.utils.schedule import compute_ramped_lrate as j_lrate
from spr_pick_tpu_torch import losses
from spr_pick_tpu_torch.steps import ScaleByAdam
from spr_pick_tpu_torch.utils.schedule import compute_ramped_lrate

RTOL = 1e-5


def check(jfn, tfn, pred, *args):
    """Value and d/dpred of both packages on the same inputs."""
    want, want_g = jax.value_and_grad(
        lambda p: jfn(p, *[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                           for a in args]))(jnp.asarray(pred))
    p = torch.tensor(pred, requires_grad=True)
    got = tfn(p, *[torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                   for a in args])
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    g = p.grad.numpy()
    want_g = np.asarray(want_g)
    finite = np.isfinite(want_g)
    np.testing.assert_array_equal(np.isfinite(g), finite)
    np.testing.assert_allclose(g, want_g, rtol=RTOL,
                               atol=1e-7 * np.abs(want_g[finite]).max(initial=0))


def probs(shape, seed):
    rng = np.random.RandomState(seed)
    return rng.uniform(1e-3, 1 - 1e-3, size=shape).astype(np.float32)


PU_TARGETS = {
    "mixed": np.array([1.0, -1, 0.0, -1, 0.3, -1, -1, 0.9], np.float32),
    "all_labeled": np.array([1.0, 0.0, 0.2, 0.0, 0.7, 0.0, 0.0, 1.0],
                            np.float32),
    "all_unlabeled": -np.ones(8, np.float32),
}


@pytest.mark.parametrize("case", list(PU_TARGETS))
@pytest.mark.parametrize("entropy", [0.0, 0.5])
def test_pu_loss(case, entropy):
    check(lambda p, t: jlosses.pu_loss(p, t, 0.05, 4.0, entropy),
          lambda p, t: losses.pu_loss(p, t, 0.05, 4.0, entropy),
          probs((8, 1), 0), PU_TARGETS[case])


@pytest.mark.parametrize("case", ["mixed", "no_positives", "all_positive"])
def test_modified_pu_loss(case):
    t = np.zeros((4, 6, 6, 1), np.float32)
    if case != "no_positives":
        t[0, 2, 3] = 1.0
        t[2, 1, 1] = 1.0
    if case == "all_positive":
        t[1, 0, 0] = t[3, 5, 5] = 1.0
    check(lambda p, tt: jlosses.modified_pu_loss(p, tt, 0.1, 1.0, 0.2),
          lambda p, tt: losses.modified_pu_loss(p, tt, 0.1, 1.0, 0.2),
          probs((4, 6, 6, 1), 1), t)


@pytest.mark.parametrize("positives", [True, False])
def test_focal_loss(positives):
    gt = np.random.RandomState(2).uniform(0, 0.9, (2, 8, 8, 1)).astype(
        np.float32)
    if positives:
        gt[0, 3, 3] = gt[1, 5, 2] = 1.0
    check(jlosses.focal_loss, losses.focal_loss, probs((2, 8, 8, 1), 3), gt)


@pytest.mark.parametrize("beta", [0.0, 10.0])
def test_pu_focal_loss(beta):
    gt = np.random.RandomState(4).uniform(0, 1, (2, 8, 8, 1)).astype(
        np.float32)
    gt[0, :2] = -1.0
    gt[1, 4, 4] = 1.0
    check(lambda p, g: jlosses.pu_focal_loss(p, g, 0.1, beta),
          lambda p, g: losses.pu_focal_loss(p, g, 0.1, beta),
          probs((2, 8, 8, 1), 5), gt)


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_js_div_loss_2d(reduction):
    q = probs((2, 6, 5, 3), 6)
    check(lambda p, t: jlosses.js_div_loss_2d(p, t, reduction),
          lambda p, t: losses.js_div_loss_2d(p, t, reduction),
          probs((2, 6, 5, 3), 7), q)
    got = losses.js_div_loss_2d(torch.from_numpy(q), torch.from_numpy(q),
                                "none")
    assert got.shape == (2, 3) and float(got.abs().max()) < 1e-6


def test_bce_and_binom_logpmf():
    p, t = probs((50,), 8), probs((50,), 9)
    np.testing.assert_allclose(
        losses.bce(torch.from_numpy(p), torch.from_numpy(t)).numpy(),
        np.asarray(jlosses.bce(jnp.asarray(p), jnp.asarray(t))), rtol=RTOL)
    k = np.arange(0, 17, dtype=np.float32)
    for n in (0.0, 5.0, 16.0):
        np.testing.assert_allclose(
            losses.binom_logpmf(torch.from_numpy(k), torch.tensor(n),
                                0.05).numpy(),
            np.asarray(jlosses.binom_logpmf(jnp.asarray(k), n, 0.05)),
            rtol=RTOL, atol=1e-5)


def test_adam_matches_optax_scale_by_adam():
    """Three steps of the same gradients; LR applied outside (steps.py:65-67),
    a different LR each step as the cosine ramp gives."""
    rng = np.random.RandomState(10)
    shapes = [(3, 3, 4, 5), (5,), (1, 1, 1, 1)]
    params = [np.zeros(s, np.float32) for s in shapes]
    tx = optax.scale_by_adam(b1=0.9, b2=0.99, eps=1e-8)
    j_params = [jnp.asarray(p) for p in params]
    j_state = tx.init(j_params)
    t_params = [torch.tensor(p) for p in params]
    opt = ScaleByAdam(t_params)
    for step, lr in enumerate((1e-4, 3e-4, 2e-4)):
        grads = [rng.randn(*s).astype(np.float32) for s in shapes]
        updates, j_state = tx.update([jnp.asarray(g) for g in grads], j_state,
                                     j_params)
        updates = [-jnp.float32(lr) * u for u in updates]
        j_params = optax.apply_updates(j_params, updates)
        for p, g in zip(t_params, grads):
            p.grad = torch.from_numpy(g)
        opt.step(lr)
        assert opt.count == step + 1 == int(j_state.count)
        for p, jp in zip(t_params, j_params):
            np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-6)
        for m, jm in zip(opt.mu, j_state.mu):
            np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-6)
        for v, jv in zip(opt.nu, j_state.nu):
            np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-6)


class _View:
    """What a trainer's `learning_rate` property reads."""

    base_learning_rate = 1e-4

    def __init__(self, state, cfg):
        self.state, self.cfg = state, cfg


@pytest.mark.parametrize("i", [0, 100, 1999, 2000, 2001, 3000, 5000, 6000,
                               9999, 10000])
def test_lr_schedule_at_the_swapped_call_site(i):
    """Both trainers' `learning_rate` (train.py:243-250) on the cfg
    defaults (ramp-down 0.7, ramp-up 0.2, passed swapped), and the bare
    function on the same arguments."""
    from spr_pick_tpu.params import ConfigValue as JCV
    from spr_pick_tpu.params import StateValue as JSV
    from spr_pick_tpu.train import DenoiserTrainer as JTrainer
    from spr_pick_tpu_torch.params import ConfigValue, StateValue
    from spr_pick_tpu_torch.train import DenoiserTrainer

    n = 10000

    def view(cv, sv):
        return _View({sv.ITERATION: i}, {
            cv.ITERATIONS: n, cv.LR_RAMPDOWN_FRACTION: 0.7,
            cv.LR_RAMPUP_FRACTION: 0.2})

    want = JTrainer.learning_rate.fget(view(JCV, JSV))
    got = DenoiserTrainer.learning_rate.fget(view(ConfigValue, StateValue))
    assert got == want
    assert compute_ramped_lrate(i, n, 0.3, 0.5, 1e-4) == j_lrate(
        i, n, 0.3, 0.5, 1e-4)
