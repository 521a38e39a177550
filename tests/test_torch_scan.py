"""The K-step training chunks of the port against the JAX package's scans,
against the port's own per-step loop, and in the trainer.

  * `make_train_scan`: K = 3 joint steps at batch 3 on 64^2 crops of a
    two-image stack, the full-width model of `tests/test_torch_train_step.py`
    (seeded weights, random biases and BatchNorm statistics), float32,
    sequential flip-TTA (the form of the default batch 16), the same
    (K, B) indices, labels and learning rates.  The draws are the JAX
    scan's own: the flips are `jax.random.bernoulli` of each step key's
    first split and the flip draw the `uniform` of the second split's
    second split, both computed here and handed to the port; the sample
    noise is injected on both sides (``jax.random.normal`` replaced while
    the scan traces by seeded arrays chosen by the step index, which a
    wrapped ``jax.lax.scan`` carries; the JAX package is unchanged).
  * `make_denoise_scan`: K = 3 ssdn steps (one channel, learnt constant
    noise) at batch 2 on 64^2 corner crops from the JAX package's initial
    weights, the detector's sample noise injected the same way.
  * The port's eager chunk against K calls of the port's `train_step` on
    the same batches, generators and learning rates: equal, bit for bit
    (joint, and n2v with a range noise style, whose reference noise and
    UPS masks come from the data plane's generator).
  * The trainer with chunks of 3 steps (print interval 3 batches) against
    the same run with every chunk forced to one step: equal weights,
    BatchNorm statistics and Adam state, bit for bit (the flips of a
    chunk are the numbers 3 batches draw).

Tolerances against JAX after K steps, from the one-step tests' (loss 1e-5
relative, the flip-consistency term 1e-6 absolute, gradients 3e-3 of a
leaf's largest, BatchNorm 1e-6).  The first step's losses are held to
those.  Adam divides a moment by the root of the squared one, so a
gradient entry that two packages round to different sides of zero
(max-pool ties) moves its parameter by up to 2 lr a step: the parameters
are held within 2 * sum(lr) of JAX's, element by element (this test reads
0.63 of that), and their change over the K steps within REL_L2_DELTA
relative L2 over all leaves (it reads 7.6e-3 joint, 1.9e-3 ssdn).  Later
steps take their gradients at those weights, so their losses are held to
LOSS_RTOL_K (it reads 8e-4), the moments to MOMENT_REL of a leaf's largest
entry (it reads 1.15e-2; the detector's input BatchNorm, whose gradient is
zero up to rounding, K times the step test's 1e-5 absolute) and the
BatchNorm statistics to BN_REL of a leaf's largest (it reads 5.1e-4, the
input BatchNorm's variance, which the U-Net's drifting output feeds).
The scan runs unrolled here: the same steps, but XLA's CPU while loop runs
these convolutions some 70 times slower than straight-line code.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from spr_pick_tpu import steps as jsteps
from spr_pick_tpu.denoiser import Denoiser as JDenoiser
from spr_pick_tpu.params import ConfigValue as JCV
from spr_pick_tpu_torch import weights
from spr_pick_tpu_torch.denoiser import Denoiser
from spr_pick_tpu_torch.parallel.mesh import owned_crops
from spr_pick_tpu_torch.params import ConfigValue
from spr_pick_tpu_torch.steps import (TrainState, make_denoise_scan,
                                      make_optimizer, make_train_scan,
                                      train_step)
from tests.test_torch_denoise_step import cfgs as dn_cfgs
from tests.test_torch_denoise_step import jax_init
from tests.test_torch_train_step import cfgs as joint_cfgs
from tests.test_torch_train_step import leaves, port_denoiser

K = 3
B = 3
PATCH = 64
ALPHA, TAU = 0.75, 0.05
LRS = np.array([1e-4, 2e-4, 5e-5], np.float32)
RTOL_LOSS = 1e-5
ATOL_AUG = 1e-6
LOSS_RTOL_K = 2e-3
MOMENT_REL = 2e-2
ATOL_ZERO_GRAD_K = 1e-5 * K
BN_REL = 1e-3
REL_L2_DELTA = 2e-2


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads: beside five other test workers on the same
    cores, torch's default of one thread a core oversubscribes them and
    this file ran some 15 times slower than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def stack(n, h, w, seed):
    return np.random.RandomState(seed).rand(n, h, w).astype(np.float32)


def centres(rng, n, h, w, shape):
    half = PATCH // 2
    flat = rng.randint(n, size=shape).astype(np.int32)
    ys = rng.randint(half, h - half + 1, size=shape).astype(np.int32)
    xs = rng.randint(half, w - half + 1, size=shape).astype(np.int32)
    return flat, ys, xs


def corners(rng, n, h, w, shape, patch=PATCH):
    flat = rng.randint(n, size=shape).astype(np.int32)
    ys = rng.randint(0, h - patch + 1, size=shape).astype(np.int32)
    xs = rng.randint(0, w - patch + 1, size=shape).astype(np.int32)
    return flat, ys, xs


class InjectedNormal:
    """While active, ``jax.lax.scan`` carries its step index and
    ``jax.random.normal`` returns ``table[call][step]``, ``call`` counting
    the draws of one traced step."""

    def __init__(self, table):
        self.table = jnp.asarray(table)
        self.step = None
        self.calls = 0

    def __enter__(self):
        self.scan, self.normal = jax.lax.scan, jax.random.normal
        inj = self

        def scan(body, init, xs):
            def indexed(carry, x):
                inj.step, inj.calls = x[0], 0
                return body(carry, x[1])

            return inj.scan(indexed, init, (jnp.arange(K), xs), unroll=True)

        def normal(key, shape, dtype=jnp.float32):
            got = inj.table[inj.calls][inj.step]
            inj.calls += 1
            assert got.shape == tuple(shape), shape
            return got.astype(dtype)

        jax.lax.scan, jax.random.normal = scan, normal
        return self

    def __exit__(self, *exc):
        jax.lax.scan, jax.random.normal = self.scan, self.normal


def jax_state(trainable, static):
    return jsteps.TrainState(
        step=jnp.zeros((), jnp.int32), trainable=trainable, static=static,
        opt_state=optax.scale_by_adam(b1=0.9, b2=0.99, eps=1e-8).init(
            trainable))


def port_state(den):
    return TrainState(step=0, denoiser=den, opt=make_optimizer(den))


def port_results(state):
    den, opt = state.denoiser, state.opt
    trainable, static = den.variables()
    names = den.named_trainable()

    def tree(ts):
        return weights.named_to_flax((g, k, t) for (g, k, _), t
                                     in zip(names, ts))

    return dict(trainable=trainable, static=static, count=opt.count,
                count_t=float(opt.count_t), mu=tree(opt.mu), nu=tree(opt.nu))


def jax_results(state):
    opt = state.opt_state
    return dict(trainable=state.trainable, static=state.static,
                count=int(opt.count), mu=opt.mu, nu=opt.nu)


# ---------------------------------------------------------------------------
# Against the JAX scans
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def joint():
    """Both packages' joint chunk from the same weights and draws."""
    c, j = joint_cfgs()
    den = port_denoiser(c, fold=False)
    trainable, static = den.variables()
    images = stack(2, 96, 112, seed=3)
    rng = np.random.RandomState(4)
    flat, ys, xs = centres(rng, 2, 96, 112, (K, B))
    labels = rng.choice(np.float32([0.9, -1.0, 0.0, 1.0]), (K, B))
    eps = rng.randn(2, K, B, PATCH, PATCH, 1).astype(np.float32)

    base = jax.random.PRNGKey(7)
    flips, flip_p = [], []
    for key in jax.random.split(base, K):
        k_flip, k_step = jax.random.split(key)
        flips.append(np.asarray(jax.random.bernoulli(k_flip, 0.5, (B,))))
        _, k_flip_p, _ = jax.random.split(k_step, 3)
        flip_p.append(np.float32(jax.random.uniform(k_flip_p)))
    flips = np.stack(flips).astype(np.int32)

    jden = JDenoiser(j, mode="joint", fold_tta=False)
    scan = jsteps.make_train_scan(jden, ALPHA, TAU, crop=PATCH)
    with InjectedNormal(eps):
        jstate, jmetrics = scan(
            jax_state(trainable, static), jnp.asarray(images),
            jnp.asarray(flat), jnp.asarray(ys), jnp.asarray(xs),
            jnp.asarray(labels), jnp.asarray(LRS), base)

    den.load_variables(trainable, static)
    state = port_state(den)
    draws = [{"eps": torch.from_numpy(eps[0, i]),
              "eps2": torch.from_numpy(eps[1, i]),
              "flip_p": torch.tensor(flip_p[i])} for i in range(K)]
    metrics = make_train_scan(den, ALPHA, TAU, PATCH)(
        state, torch.from_numpy(images), flat, ys, xs, flips, labels, LRS,
        None, draws=draws)
    return dict(jax=jax_results(jstate), jax_metrics=jmetrics,
                port=port_results(state), port_metrics=metrics,
                before=trainable, before_static=static, flips=flips)


@pytest.fixture(scope="module")
def denoise():
    """Both packages' ssdn chunk from the JAX initial weights."""
    c, j = dn_cfgs("ssdn", "const")
    jden = JDenoiser(j, mode="denoise")
    trainable, static = jax_init(jden, PATCH)
    images = stack(2, 80, 96, seed=5)
    rng = np.random.RandomState(6)
    flat, ys, xs = corners(rng, 2, 80, 96, (K, 2))
    eps = rng.randn(1, K, 2, PATCH, PATCH, 1).astype(np.float32)

    scan = jsteps.make_denoise_scan(jden, 0.8, 0.01, PATCH,
                                    j[JCV.ALGORITHM], j[JCV.NOISE_STYLE])
    with InjectedNormal(eps):
        jstate, jmetrics = scan(
            jax_state(trainable, static), jnp.asarray(images),
            jnp.asarray(flat), jnp.asarray(ys), jnp.asarray(xs),
            jnp.asarray(LRS), jax.random.PRNGKey(8))

    den = Denoiser(c, mode="denoise", device="cpu")
    den.load_variables(trainable, static)
    den.train()
    state = port_state(den)
    draws = [{"eps": torch.from_numpy(eps[0, i])} for i in range(K)]
    metrics = make_denoise_scan(den, 0.8, 0.01, PATCH,
                                c[ConfigValue.ALGORITHM],
                                c[ConfigValue.NOISE_STYLE])(
        state, torch.from_numpy(images), flat, ys, xs, LRS, None, None,
        draws=draws)
    return dict(jax=jax_results(jstate), jax_metrics=jmetrics,
                port=port_results(state), port_metrics=metrics,
                before=trainable, before_static=static)


def test_the_flips_cover_both_values(joint):
    assert 0 < joint["flips"].sum() < joint["flips"].size


@pytest.mark.parametrize("case", ["joint", "denoise"])
def test_metric_stacks_match_jax(case, request):
    r = request.getfixturevalue(case)
    got, want = r["port_metrics"], r["jax_metrics"]
    assert set(got) == set(want)
    for name, w in want.items():
        g, w = got[name].numpy(), np.asarray(w)
        assert g.shape == w.shape == (K,), name
        if name == "aug_loss":
            np.testing.assert_allclose(g[0], w[0], rtol=0, atol=ATOL_AUG)
        else:
            np.testing.assert_allclose(g[0], w[0], rtol=RTOL_LOSS,
                                       err_msg=name)
        np.testing.assert_allclose(g, w, rtol=LOSS_RTOL_K, err_msg=name)


@pytest.mark.parametrize("case", ["joint", "denoise"])
def test_parameters_after_k_steps_match_jax(case, request):
    r = request.getfixturevalue(case)
    got = dict(leaves(r["port"]["trainable"]))
    want = dict(leaves(r["jax"]["trainable"]))
    before = dict(leaves(r["before"]))
    assert got.keys() == want.keys()
    num = den = 0.0
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0,
                                   atol=2 * float(LRS.sum()), err_msg=name)
        num += float(np.sum((got[name] - w) ** 2))
        den += float(np.sum((w - before[name]) ** 2))
    assert den > 0 and (num / den) ** 0.5 <= REL_L2_DELTA


@pytest.mark.parametrize("case", ["joint", "denoise"])
def test_batchnorm_statistics_match_jax(case, request):
    r = request.getfixturevalue(case)
    got = dict(leaves(r["port"]["static"]["model"]))
    want = dict(leaves(r["jax"]["static"]["model"]))
    before = dict(leaves(r["before_static"]["model"]))
    assert got.keys() == want.keys() and len(got) == 18
    for name, w in want.items():
        assert np.any(w != before[name]), name
        np.testing.assert_allclose(got[name], w, rtol=0,
                                   atol=BN_REL * float(np.abs(w).max()),
                                   err_msg=name)


@pytest.mark.parametrize("case", ["joint", "denoise"])
def test_adam_state_matches_optax(case, request):
    r = request.getfixturevalue(case)
    assert r["port"]["count"] == r["jax"]["count"] == K
    assert r["port"]["count_t"] == K
    for key, power in (("mu", 1), ("nu", 2)):
        got = dict(leaves(r["port"][key]))
        want = dict(leaves(r["jax"][key]))
        assert got.keys() == want.keys()
        for name, w in want.items():
            if not np.any(w):  # ssdn's detector: no loss reaches it
                assert not np.any(got[name]), f"{key}{name}"
                continue
            if "/input_bn/" in name:
                atol = ATOL_ZERO_GRAD_K ** power
            else:
                atol = MOMENT_REL * float(np.abs(w).max())
                assert atol > 0, name
            np.testing.assert_allclose(got[name], w, rtol=0, atol=atol,
                                       err_msg=f"{key}{name}")


# ---------------------------------------------------------------------------
# The chunk against the per-step loop
# ---------------------------------------------------------------------------

def assert_states_equal(a, b):
    for x, y in zip(a.denoiser.state_tensors(), b.denoiser.state_tensors()):
        assert torch.equal(x, y)
    for xs, ys in ((a.opt.mu, b.opt.mu), (a.opt.nu, b.opt.nu)):
        for x, y in zip(xs, ys):
            assert torch.equal(x, y)
    assert a.opt.count == b.opt.count == int(a.opt.count_t) == \
        int(b.opt.count_t)
    assert a.step == b.step


def test_joint_chunk_equals_k_train_steps():
    c, _ = joint_cfgs()
    images = torch.from_numpy(stack(2, 96, 112, seed=9))
    rng = np.random.RandomState(10)
    flat, ys, xs = centres(rng, 2, 96, 112, (K, B))
    flips = rng.randint(2, size=(K, B)).astype(np.int32)
    labels = rng.choice(np.float32([0.9, -1.0, 0.0]), (K, B))
    states = [port_state(port_denoiser(c, fold=False)) for _ in range(2)]
    gens = [torch.Generator().manual_seed(11) for _ in range(2)]

    got = make_train_scan(states[0].denoiser, ALPHA, TAU, PATCH)(
        states[0], images, flat, ys, xs, flips, labels, LRS, gens[0])
    want = []
    for i in range(K):
        batch = {"inp": owned_crops(images, 0, flat[i], ys[i], xs[i],
                                    flips[i], PATCH, True)[..., None],
                 "target": torch.from_numpy(labels[i])}
        want.append(train_step(states[1], batch, float(LRS[i]), ALPHA, TAU,
                               generator=gens[1]))
    assert_states_equal(*states)
    for name, stacked in got.items():
        assert torch.equal(stacked, torch.stack(
            [torch.mean(m[name]).float() for m in want])), name
    assert torch.equal(gens[0].get_state(), gens[1].get_state())


def test_n2v_chunk_equals_k_train_steps():
    from spr_pick_tpu_torch.data.noisy import prepare_batch_torch

    c, _ = dn_cfgs("n2v")
    c[ConfigValue.NOISE_STYLE] = "gauss10_50"  # a range style: item draws
    images = torch.from_numpy(stack(2, 48, 40, seed=12))
    flat, ys, xs = corners(np.random.RandomState(13), 2, 48, 40, (K, 2),
                           patch=32)
    states = []
    for _ in range(2):
        den = Denoiser(c, mode="denoise", device="cpu")
        den.init_variables(seed=0)
        states.append(port_state(den.train()))
    gens = [torch.Generator().manual_seed(14) for _ in range(2)]
    data_gens = [torch.Generator().manual_seed(15) for _ in range(2)]

    algorithm, style = c[ConfigValue.ALGORITHM], c[ConfigValue.NOISE_STYLE]
    got = make_denoise_scan(states[0].denoiser, 0.8, 0.01, 32, algorithm,
                            style)(
        states[0], images, flat, ys, xs, LRS, gens[0], data_gens[0])
    losses = []
    for i in range(K):
        batch = prepare_batch_torch(
            owned_crops(images, 0, flat[i], ys[i], xs[i], None, 32, False),
            algorithm, style, data_gens[1])
        losses.append(torch.mean(train_step(
            states[1], batch, float(LRS[i]), 0.8, 0.01,
            generator=gens[1])["loss"]))
    assert_states_equal(*states)
    assert torch.equal(got["loss"], torch.stack(losses))
    assert torch.equal(data_gens[0].get_state(), data_gens[1].get_state())


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------

def test_trainer_chunks_equal_single_steps(tmp_path, monkeypatch):
    """Chunks of 3 steps (print interval 12 at batch 4) against the same
    run forced to one step a chunk: the same final state, bit for bit,
    and the same logged losses (a chunk logs each step's batch mean in
    float32, a step each item's loss, so the means agree to 1e-6)."""
    import json
    import os

    from spr_pick_tpu_torch import train as train_mod
    from tests.test_e2e import make_synthetic_dataset
    from tests.test_torch_trainer import make_cfg

    images, coords = make_synthetic_dataset(
        tmp_path, np.random.RandomState(0), n_images=2, size=256,
        n_particles=4)
    chunks = []
    run_chunk = train_mod.DenoiserTrainer._run_chunk

    def counting(self, iteration, k, batch_size):
        chunks.append(k)
        return run_chunk(self, iteration, k, batch_size)

    monkeypatch.setattr(train_mod.DenoiserTrainer, "_run_chunk", counting)
    runs = {}
    for label in ("chunked", "single"):
        if label == "single":
            monkeypatch.setattr(train_mod.DenoiserTrainer, "_chunk_steps",
                                lambda self, it, b: 1)
        t = train_mod.DenoiserTrainer(
            make_cfg(iterations=24, batch=4, eval_interval=0,
                     print_interval=12, snapshot=24),
            alpha=0.75, tau=0.05, runs_dir=str(tmp_path / label),
            device="cpu")
        t.set_train_data(images)
        t.set_train_label(coords)
        t.train()
        with open(os.path.join(t.run_dir_path, "scalars.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        runs[label] = (t, [r for r in rows if r["tag"].startswith("train/")
                           and r["tag"] != "train/learning_rate"])
    assert chunks == [3, 3]
    (a, rows_a), (b, rows_b) = runs["chunked"], runs["single"]
    assert a.iteration == b.iteration == 24
    assert_states_equal(a.train_state, b.train_state)
    assert [(r["tag"], r["step"]) for r in rows_a] == \
        [(r["tag"], r["step"]) for r in rows_b] and rows_a
    for x, y in zip(rows_a, rows_b):
        np.testing.assert_allclose(x["value"], y["value"], rtol=1e-6,
                                   err_msg=x["tag"])
