"""The sharded K-step chunks under a process group: what a CUDA graph of
their step needs, checked on two gloo ranks on the CPU, and the port's
sharded joint chunk against the JAX package's `make_train_scan_sharded`.

On cards, `make_train_scan_sharded` and `make_denoise_scan_sharded` replay
one CUDA graph of the step on every rank, its NCCL collectives captured
(`utils/cuda_graph.py`).  A rank's replay launches the collectives it
captured, so the capture is sound only if every rank issues the same
collectives in the same order at every step, and if the step reads
nothing on the host.  Two processes join a gloo group on 127.0.0.1 (this
file is also their program, as in `tests/test_torch_ddp.py`) and run K = 3
steps of the sharded joint (sequential flip-TTA), ssdn and n2v chunks at
global batch 4 from a 3-image stack, recording every collective (op,
dtype, element count) and every host read (``item``, ``tolist``, ``cpu``,
``numpy``, ``bool``, ``float``, ``int`` of a tensor) inside a step, and the
addresses of the gradients.  A stubbed capture that fails on rank 1 must
raise on both ranks, and leaving the group releases the graphs the mesh
holds first.

Against JAX: the port's sharded joint chunk on the two ranks, K = 3 steps
at batch 4 on 64^2 crops of a two-image stack (one image a rank), against
`make_train_scan_sharded` on a 2-device CPU mesh from the same weights
(those of `tests/test_torch_train_step.py`), indices, labels, learning
rates and draws (the JAX scan's own flips and flip draws, the sample noise
injected on both sides; the scan runs unrolled, as in
`tests/test_torch_scan.py`).  The first step's losses are held to that
file's tolerances (1e-5 relative, the flip-consistency term 1e-6
absolute), the parameters within 2 * sum(lr) of JAX's element by element.
After K steps the loss stacks (largest relative deviation of each metric)
and the parameters' change over them (relative L2) are held to that
file's 2e-3 and 2e-2, or, where the port's one-process chunk on the same
inputs reads a larger drift against JAX's one-device `make_train_scan`
(also run here), to DRIFT_RATIO times that reading: the sharding must add
no drift of its own.  Beside it, the reference's own sharded form against
its one-device form: the port's sharded chunk may move from its
one-process chunk by no more than that (SHARDED_RTOL and SHARDED_REL_L2
bound it too).

On these inputs the port's drift from JAX is past that file's tolerances
(about 1.1e-2 at step 2's loss, a near-cancelling sum, and 3.6e-2 for the
parameters' change), some 60 and 14 times the reference's sharded-against-
one-device drift, which only reorders a few sums.  Two tests show why:

  * the first step's gradient sits at a discontinuity of the detector's:
    moving the stack by one ulp moves the port's own gradient (the same
    detector leaves, by up to a third of a leaf's largest entry) as far as
    it is from JAX's;
  * Adam turns every entry whose update has another sign on the two sides
    into a move of about 2 lr: with those entries (about 0.1% of them a
    step) set to JAX's after each step, parameters and moments alike, the
    port stays within that file's tolerances over the K steps.
"""

import contextlib
import os
import pickle
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

REPO = Path(__file__).resolve().parent.parent
K = 3
B = 4
PATCH = 64
N2V_PATCH = 32
LRS = np.array([1e-4, 2e-4, 5e-5], np.float32)
KINDS = ("joint", "ssdn", "n2v")
TIMEOUT = 120
# All-reduces a step issues on each rank.  joint: the crops' sum, the
# detector's 9 BatchNorm layers' global moments in each of its 2 forwards
# (36, a forward and a backward one each), the PU loss's sums and the
# consistency mean (2 each), the gradient average and the 6 metrics.
# ssdn: the crops' sum, the detector's 9 moments under no_grad, the
# gradient average and 3 metrics.  n2v: the crops' sum, the gradient
# average and its one metric.
COLLECTIVES = {"joint": 48, "ssdn": 14, "n2v": 3}
# Against JAX after K steps: the sharded forms' drift from each other over
# the one-process forms' drift on the same inputs (the tolerances of
# tests/test_torch_scan.py where those hold).  The sharding itself moves
# the port by 6.3e-6 (losses) and 3.7e-5 (parameters' change), JAX by
# 1.7e-4 and 2.6e-3.
DRIFT_RATIO = 1.1
SHARDED_RTOL = 1e-4
SHARDED_REL_L2 = 1e-3
# The first step's gradient against JAX's, relative L2 over all leaves
# (reads 1.36e-3), and the share of entries a step whose update sign the
# two packages disagree on (reads at most 3.0e-3, at step 3).
GRAD_REL_L2 = 2e-3
HELD_SHARE = 5e-3
RECORDED = ("all_reduce", "all_gather_single", "all_gather_into_tensor",
            "all_gather", "broadcast", "reduce_scatter_tensor",
            "all_to_all_single", "barrier")
HOST_READS = ("item", "tolist", "cpu", "numpy", "__bool__", "__float__",
              "__int__")


# ---------------------------------------------------------------------------
# What the ranks run
# ---------------------------------------------------------------------------

class Recorder:
    """While active: each call of a wrapped step opens a new list of the
    collectives it issues, and a host read of a tensor inside a step is
    recorded with the line that made it."""

    def __init__(self):
        self.steps = []
        self.reads = []
        self.inside = False
        self._saved = []

    def __enter__(self):
        for name in RECORDED:
            if hasattr(dist, name):
                self._patch(dist, name, self._collective(name))
        for name in HOST_READS:
            self._patch(torch.Tensor, name, self._read(name))
        return self

    def __exit__(self, *exc):
        for owner, name, value in reversed(self._saved):
            setattr(owner, name, value)

    def _patch(self, owner, name, make):
        orig = getattr(owner, name)
        self._saved.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def _collective(self, name):
        def make(orig):
            def call(*args, **kwargs):
                if self.inside:
                    t = args[-1] if name.startswith("all_gather") else args[0]
                    op = kwargs.get("op", args[1] if name == "all_reduce"
                                    and len(args) > 1 else None)
                    self.steps[-1].append(
                        (name, str(op), str(t.dtype), t.numel()))
                return orig(*args, **kwargs)
            return call
        return make

    def _read(self, name):
        def make(orig):
            def call(t, *args, **kwargs):
                if self.inside:
                    where = traceback.extract_stack()[-2]
                    self.reads.append(f"{name} at {where.filename}:"
                                      f"{where.lineno}")
                return orig(t, *args, **kwargs)
            return call
        return make

    def wrap(self, chunk):
        """Record each step of ``chunk``, and the addresses of the
        gradients after it."""
        step = chunk.step
        addresses = []

        def recorded(state, *args, **kwargs):
            self.steps.append([])
            self.inside = True
            try:
                out = step(state, *args, **kwargs)
            finally:
                self.inside = False
            addresses.append([p.grad.data_ptr() for p in state.opt.params])
            return out

        chunk.step = recorded
        return addresses


def stack_and_draws(kind):
    rng = np.random.RandomState({"joint": 3, "ssdn": 4, "n2v": 5}[kind])
    stack = rng.rand(3, 96, 128).astype(np.float32)
    patch = N2V_PATCH if kind == "n2v" else PATCH
    flat = rng.randint(3, size=(K, B)).astype(np.int32)
    half = patch // 2 if kind == "joint" else 0
    ys = rng.randint(half, 96 - patch + half + 1, size=(K, B)).astype(
        np.int32)
    xs = rng.randint(half, 128 - patch + half + 1, size=(K, B)).astype(
        np.int32)
    extra = ()
    if kind == "joint":
        extra = (rng.randint(2, size=(K, B)).astype(np.int32),
                 rng.choice(np.float32([0.9, -1.0, 0.0]), (K, B)))
    return stack, patch, (flat, ys, xs) + extra


def chunk_cfg(kind):
    from spr_pick_tpu_torch import cfg as cfg_mod
    from spr_pick_tpu_torch.params import (ConfigValue, NoiseAlgorithm,
                                           NoiseValue)

    c = cfg_mod.base()
    c[ConfigValue.COMPUTE_DTYPE] = "f32"
    c[ConfigValue.TRAIN_MINIBATCH_SIZE] = B
    if kind == "joint":
        c[ConfigValue.ALGORITHM] = NoiseAlgorithm.SELFSUPERVISED_DENOISING
        c[ConfigValue.NOISE_STYLE] = "gauss"
    else:
        c[ConfigValue.ALGORITHM] = NoiseAlgorithm(kind)
        c[ConfigValue.NOISE_STYLE] = "gauss10_50"
    if kind != "n2v":
        c[ConfigValue.NOISE_VALUE] = NoiseValue.UNKNOWN_CONSTANT
    return c


def recorded_chunk(kind, mesh):
    """K steps of the sharded chunk of ``kind`` on this rank, recorded."""
    from spr_pick_tpu_torch.denoiser import Denoiser
    from spr_pick_tpu_torch.parallel.mesh import shard_stack
    from spr_pick_tpu_torch.params import ConfigValue
    from spr_pick_tpu_torch.steps import (TrainState,
                                          make_denoise_scan_sharded,
                                          make_optimizer,
                                          make_train_scan_sharded)

    c = chunk_cfg(kind)
    stack, patch, draws = stack_and_draws(kind)
    den = Denoiser(c, mode="joint" if kind == "joint" else "denoise",
                   device="cpu", mesh=mesh,
                   fold_tta=False if kind == "joint" else None)
    den.init_variables(seed=0)
    den.train()
    state = TrainState(step=0, denoiser=den, opt=make_optimizer(den))
    gens = [torch.Generator().manual_seed(11 + i) for i in range(2)]
    images = shard_stack(stack, mesh)[0]
    if kind == "joint":
        scan = make_train_scan_sharded(den, 0.75, 0.05, patch, mesh)
        args = (*draws, LRS, gens[0])
    else:
        scan = make_denoise_scan_sharded(den, 0.8, 0.01, patch,
                                         c[ConfigValue.ALGORITHM],
                                         c[ConfigValue.NOISE_STYLE], mesh)
        args = (*draws, LRS, *gens)
    with Recorder() as rec:
        addresses = rec.wrap(scan.chunk)
        metrics = scan(state, images, *args)
    return dict(steps=rec.steps, reads=rec.reads, addresses=addresses,
                loss=metrics["loss"].numpy())


def capture_agreement(mesh):
    """`GraphedSteps` with the CUDA calls stubbed: three eager warm-up
    steps (each an all-reduce), then a capture that fails on rank 1 alone.
    A real capture executes nothing, so the stub runs no collective while
    capturing.  Returns (the error each rank raised, its eager steps, the
    seconds the run took)."""
    from spr_pick_tpu_torch.utils import cuda_graph

    capturing = []

    class Stream:
        def wait_stream(self, other):
            pass

    class Graph:
        def register_generator_state(self, generator):
            pass

    @contextlib.contextmanager
    def graph(g, *args, **kwargs):
        if mesh.rank == 1:
            raise RuntimeError("rank 1: the stubbed capture failed")
        capturing.append(True)
        try:
            yield
        finally:
            capturing.pop()

    def step(row):
        out = row.float()
        if not capturing:
            dist.all_reduce(out)
        return out

    saved = {name: getattr(torch.cuda, name)
             for name in ("CUDAGraph", "graph", "current_stream", "Stream",
                          "stream")}
    torch.cuda.CUDAGraph, torch.cuda.graph = Graph, graph
    torch.cuda.current_stream = torch.cuda.Stream = lambda *a: Stream()
    torch.cuda.stream = lambda s: contextlib.nullcontext()
    steps = cuda_graph.GraphedSteps(step, [], [], mesh=mesh)
    t0 = time.perf_counter()
    try:
        steps.run(torch.zeros((5, 2), dtype=torch.int32))
        error = None
    except RuntimeError as exc:
        error = str(exc)
    finally:
        for name, value in saved.items():
            setattr(torch.cuda, name, value)
    return error, steps.eager_steps, time.perf_counter() - t0


def parity_chunk(mesh, d):
    """The joint chunk from the weights and draws in ``d`` (the JAX scan's
    own): sharded over ``mesh``, or on the whole stack in one process
    without one.  Metric stacks and trainable variables."""
    from spr_pick_tpu_torch.denoiser import Denoiser
    from spr_pick_tpu_torch.parallel.mesh import shard_stack
    from spr_pick_tpu_torch.steps import (TrainState, make_optimizer,
                                          make_train_scan,
                                          make_train_scan_sharded)
    from spr_pick_tpu_torch.utils import checkpoint as ckpt

    with open(d / "parity_inputs.pkl", "rb") as f:
        inp = pickle.load(f)
    state = ckpt.load(str(d / "joint.wt"))
    den = Denoiser(state["cfg"], mode="joint", device="cpu", mesh=mesh,
                   fold_tta=False)
    den.load_variables(state["trainable"], state["static"])
    den.train()
    ts = TrainState(step=0, denoiser=den, opt=make_optimizer(den))
    draws = [{"eps": torch.from_numpy(inp["eps"][0, i]),
              "eps2": torch.from_numpy(inp["eps"][1, i]),
              "flip_p": torch.tensor(inp["flip_p"][i])} for i in range(K)]
    if mesh is None:
        scan = make_train_scan(den, inp["alpha"], inp["tau"], PATCH)
        images = torch.from_numpy(inp["images"])
    else:
        scan = make_train_scan_sharded(den, inp["alpha"], inp["tau"], PATCH,
                                       mesh)
        images = shard_stack(inp["images"], mesh)[0]
    metrics = scan(ts, images, inp["flat"], inp["ys"], inp["xs"],
                   inp["flips"], inp["labels"], LRS, None, draws=draws)
    return dict(metrics={k: v.numpy() for k, v in metrics.items()},
                trainable=den.variables()[0])


def child(rank, size, port, out, d):
    from spr_pick_tpu_torch.parallel import mesh as mesh_mod

    torch.set_num_threads(2)
    mesh = mesh_mod.init(int(rank), int(size), "cpu",
                         f"tcp://127.0.0.1:{port}")
    try:
        result = {kind: recorded_chunk(kind, mesh) for kind in KINDS}
        result["capture"] = capture_agreement(mesh)
        result["parity"] = parity_chunk(mesh, Path(d))
    finally:
        mesh_mod.teardown(mesh)
    with open(out, "wb") as f:
        pickle.dump(result, f)


def start_ranks(d, size=2):
    from spr_pick_tpu_torch.parallel.mesh import free_port

    port = free_port()
    outs = [str(d / f"rank{r}.pkl") for r in range(size)]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(size), str(port), outs[r],
         str(d)], cwd=str(REPO), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(size)]
    return procs, outs


def join_ranks(procs, outs):
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = []
    for out in outs:
        with open(out, "rb") as f:
            results.append(pickle.load(f))
    return results


# ---------------------------------------------------------------------------
# The JAX side
# ---------------------------------------------------------------------------

def parity_inputs(d):
    """Weights, a two-image stack, the (K, B) draws and the JAX scan's own
    flips and flip draws; the weights as ``d/joint.wt`` and the rest in
    ``d/parity_inputs.pkl`` for the ranks."""
    import jax

    from spr_pick_tpu_torch.utils import checkpoint as ckpt
    from tests.test_torch_scan import ALPHA, TAU, centres, stack
    from tests.test_torch_train_step import cfgs, port_denoiser

    c, _ = cfgs()
    den = port_denoiser(c, fold=False)
    ckpt.save_weights(str(d / "joint.wt"), *den.variables(), c, "joint")
    images = stack(2, 96, 112, seed=21)
    rng = np.random.RandomState(22)
    flat, ys, xs = centres(rng, 2, 96, 112, (K, B))
    labels = rng.choice(np.float32([0.9, -1.0, 0.0, 1.0]), (K, B))
    eps = rng.randn(2, K, B, PATCH, PATCH, 1).astype(np.float32)
    base = jax.random.PRNGKey(23)
    flips, flip_p = [], []
    for key in jax.random.split(base, K):
        k_flip, k_step = jax.random.split(key)
        flips.append(np.asarray(jax.random.bernoulli(k_flip, 0.5, (B,))))
        _, k_flip_p, _ = jax.random.split(k_step, 3)
        flip_p.append(np.float32(jax.random.uniform(k_flip_p)))
    inp = dict(images=images, flat=flat, ys=ys, xs=xs, labels=labels,
               eps=eps, flips=np.stack(flips).astype(np.int32),
               flip_p=np.array(flip_p), alpha=ALPHA, tau=TAU)
    with open(d / "parity_inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    trainable, static = den.variables()
    return inp, base, trainable, static


def jax_chunk(inp, base, trainable, static):
    """`make_train_scan` on one device, the sample noise injected and the
    scan unrolled; (metrics, trainable, each step's state) as numpy, the
    states as (trainable, Adam's mu, Adam's nu) trees of (K, ...) arrays
    (the wrapped scan also returns its carry at each step)."""
    import jax
    import jax.numpy as jnp

    from spr_pick_tpu import steps as jsteps
    from spr_pick_tpu.denoiser import Denoiser as JDenoiser
    from tests.test_torch_scan import InjectedNormal, jax_state
    from tests.test_torch_train_step import cfgs

    class WithStates(InjectedNormal):
        def __enter__(self):
            super().__enter__()
            scan = jax.lax.scan

            def with_states(body, init, xs):
                def step(carry, x):
                    new, metrics = body(carry, x)
                    return new, (metrics, new)

                return scan(step, init, xs)

            jax.lax.scan = with_states
            return self

    _, j = cfgs()
    scan = jsteps.make_train_scan(JDenoiser(j, mode="joint", fold_tta=False),
                                  inp["alpha"], inp["tau"], crop=PATCH)
    with WithStates(inp["eps"]):
        state, (metrics, states) = scan(
            jax_state(trainable, static), jnp.asarray(inp["images"]),
            *(jnp.asarray(inp[k]) for k in ("flat", "ys", "xs", "labels")),
            jnp.asarray(LRS), base)
    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa
    return ({k: np.asarray(v) for k, v in metrics.items()},
            as_np(state.trainable),
            tuple(as_np(t) for t in (states.trainable, states.opt_state.mu,
                                     states.opt_state.nu)))


def port_steps(d, images, steps=K, held=None):
    """The port's one-process joint chunk from the weights and draws in
    ``d`` on ``images``, one step a call (the K-step chunk's sequence), for
    ``steps`` steps.  With ``held`` (JAX's states after each step, as from
    `jax_chunk`), after each step every entry whose parameter is more than
    lr / 2 from JAX's is set to JAX's, with its moments.  Returns the
    metric stacks, the trainable variables, Adam's mu after the first step
    (one-tenth of its gradient) as (name, array) pairs, JAX's beside it
    where ``held`` is given, and the entries held at each step."""
    import jax

    from spr_pick_tpu_torch import weights
    from spr_pick_tpu_torch.denoiser import Denoiser
    from spr_pick_tpu_torch.steps import (TrainState, make_optimizer,
                                          make_train_scan)
    from spr_pick_tpu_torch.utils import checkpoint as ckpt

    with open(d / "parity_inputs.pkl", "rb") as f:
        inp = pickle.load(f)
    state = ckpt.load(str(d / "joint.wt"))
    den = Denoiser(state["cfg"], mode="joint", device="cpu", fold_tta=False)
    den.load_variables(state["trainable"], state["static"])
    den.train()
    ts = TrainState(step=0, denoiser=den, opt=make_optimizer(den))
    opt = ts.opt
    names = den.named_trainable()
    chunk = make_train_scan(den, inp["alpha"], inp["tau"], PATCH)
    metrics, counts, first_mu, jax_first_mu = {}, [], None, None
    for i in range(steps):
        row = slice(i, i + 1)
        draws = [{"eps": torch.from_numpy(inp["eps"][0, i]),
                  "eps2": torch.from_numpy(inp["eps"][1, i]),
                  "flip_p": torch.tensor(inp["flip_p"][i])}]
        out = chunk(ts, torch.from_numpy(images), inp["flat"][row],
                    inp["ys"][row], inp["xs"][row], inp["flips"][row],
                    inp["labels"][row], LRS[row], None, draws=draws)
        for k, v in out.items():
            metrics.setdefault(k, []).append(v.numpy()[0])
        if i == 0:
            first_mu = [(f"{g}.{k}", m.numpy().copy())
                        for (g, k, _), m in zip(names, opt.mu)]
        if held is None:
            continue
        want = [[torch.as_tensor(np.asarray(a)) for a in weights.flax_to_named(
            jax.tree_util.tree_map(lambda x: x[i], tree), names)]
            for tree in held]
        n = 0
        with torch.no_grad():
            for p, mu, nu, jp, jmu, jnu in zip(opt.params, opt.mu, opt.nu,
                                               *want):
                mask = (p - jp).abs() > float(LRS[i]) / 2
                p[mask], mu[mask], nu[mask] = jp[mask], jmu[mask], jnu[mask]
                n += int(mask.sum())
        counts.append(n)
        if i == 0:
            jax_first_mu = [m.numpy() for m in want[1]]
    return dict(metrics={k: np.array(v) for k, v in metrics.items()},
                trainable=den.variables()[0], first_mu=first_mu,
                jax_first_mu=jax_first_mu, held=counts)


def jax_sharded_chunk(inp, base, trainable, static):
    """`make_train_scan_sharded` on a 2-device CPU mesh, the sample noise
    injected and the scan unrolled; (metrics, trainable) as numpy."""
    import jax
    import jax.numpy as jnp

    from spr_pick_tpu import steps as jsteps
    from spr_pick_tpu.denoiser import Denoiser as JDenoiser
    from spr_pick_tpu.parallel import mesh as jmesh
    from tests.test_torch_scan import InjectedNormal, jax_state
    from tests.test_torch_train_step import cfgs

    _, j = cfgs()
    mesh = jmesh.make_mesh(devices=jax.devices("cpu")[:2])
    jden = JDenoiser(j, mode="joint", fold_tta=False)
    scan = jsteps.make_train_scan_sharded(jden, inp["alpha"], inp["tau"],
                                          PATCH, mesh)
    indices = jmesh.shard_scan_indices(
        tuple(jnp.asarray(inp[k]) for k in ("flat", "ys", "xs", "labels")),
        mesh)
    lrs, rng = jmesh.replicate((jnp.asarray(LRS), base), mesh)
    with InjectedNormal(inp["eps"]):
        state, metrics = scan(
            jmesh.replicate(jax_state(trainable, static), mesh),
            jmesh.shard_stack(inp["images"], mesh), *indices, lrs, rng)
    return ({k: np.asarray(v) for k, v in metrics.items()},
            jax.tree_util.tree_map(np.asarray, state.trainable))


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """What the two gloo ranks recorded and computed, and on the same
    inputs the JAX sharded and one-device chunks and the port's
    one-process chunk (computed while the ranks run)."""
    d = tmp_path_factory.mktemp("mesh_graph")
    inp, base, trainable, static = parity_inputs(d)
    procs, outs = start_ranks(d)
    try:
        want = jax_sharded_chunk(inp, base, trainable, static)
        want_one = jax_chunk(inp, base, trainable, static)
        one = parity_chunk(None, d)
        held = port_steps(d, inp["images"], held=want_one[2])
        nudged = port_steps(d, np.nextafter(inp["images"], np.float32(1)),
                            steps=1)
    finally:
        results = join_ranks(procs, outs)
    return dict(results=results, jax=want, jax_one=want_one, one=one,
                held=held, nudged=nudged, before=trainable,
                flips=inp["flips"])


@pytest.mark.parametrize("kind", KINDS)
def test_every_step_issues_the_same_collectives_on_every_rank(ranks, kind):
    """The precondition of capturing the step on every rank: one sequence
    of collectives, the same at each of the K steps and on both ranks."""
    steps = [r[kind]["steps"] for r in ranks["results"]]
    assert [len(s) for s in steps] == [K, K]
    first = steps[0][0]
    print(f"{kind}: {len(first)} collectives a step: "
          f"{sorted({c[0] for c in first})}")
    assert len(first) == COLLECTIVES[kind]
    for rank_steps in steps:
        for seq in rank_steps:
            assert seq == first


@pytest.mark.parametrize("kind", KINDS)
def test_the_step_reads_nothing_on_the_host(ranks, kind):
    for r in ranks["results"]:
        assert r[kind]["reads"] == []


@pytest.mark.parametrize("kind", KINDS)
def test_gradients_keep_their_addresses(ranks, kind):
    """From the first step on, the gradients are the same tensors (a graph
    writes what it captured), and the ranks end with the same loss
    stack."""
    for r in ranks["results"]:
        addresses = r[kind]["addresses"]
        assert len(addresses) == K
        assert all(a == addresses[0] for a in addresses)
    a, b = (r[kind]["loss"] for r in ranks["results"])
    assert a.shape == (K,) and np.array_equal(a, b)


def test_a_capture_failing_on_one_rank_raises_on_every_rank(ranks):
    (err0, eager0, secs0), (err1, eager1, secs1) = (
        r["capture"] for r in ranks["results"])
    assert eager0 == eager1 == 3
    assert err1 == "rank 1: the stubbed capture failed"
    assert err0 is not None and "failed on another rank" in err0
    assert max(secs0, secs1) < 30


def test_teardown_releases_the_captured_graphs_before_the_group(
        monkeypatch):
    """NCCL does not destroy a communicator while a CUDA graph that
    captured its collectives lives: `teardown` resets the graphs the mesh
    holds (after a device synchronise) before it leaves the group."""
    from spr_pick_tpu_torch.parallel import mesh as mesh_mod

    events = []

    class Graph:
        def reset(self):
            events.append("reset")

    mesh = mesh_mod.Mesh(size=2, rank=0, device=torch.device("cpu"))
    for _ in range(2):
        mesh.hold_graph(Graph())
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: events.append("synchronize"))
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "destroy_process_group",
                        lambda: events.append("destroy"))
    mesh_mod.teardown(mesh)
    assert events == ["synchronize", "reset", "reset", "destroy"]
    assert mesh._graphs == []


def test_the_flips_cover_both_values(ranks):
    assert 0 < ranks["flips"].sum() < ranks["flips"].size


def test_sharded_joint_first_step_matches_jax(ranks):
    from tests.test_torch_scan import ATOL_AUG, RTOL_LOSS

    want = ranks["jax"][0]
    for r in ranks["results"]:
        got = r["parity"]["metrics"]
        assert set(got) == set(want)
        for name, w in want.items():
            g = got[name]
            assert g.shape == w.shape == (K,), name
            if name == "aug_loss":
                np.testing.assert_allclose(g[0], w[0], rtol=0, atol=ATOL_AUG)
            else:
                np.testing.assert_allclose(g[0], w[0], rtol=RTOL_LOSS,
                                           err_msg=name)


def metric_drift(got, want):
    """Each metric's largest relative deviation over the K steps."""
    return {n: float(np.max(np.abs(got[n] - w) / np.abs(w)))
            for n, w in want.items()}


def change_drift(got, want, before):
    """Relative L2 over all leaves of ``got`` from ``want``, over the
    change of ``want`` from ``before``."""
    num = sum(float(np.sum((got[n] - w) ** 2)) for n, w in want.items())
    den = sum(float(np.sum((w - before[n]) ** 2)) for n, w in want.items())
    assert den > 0
    return (num / den) ** 0.5


def test_sharded_joint_metric_stacks_match_jax(ranks):
    """The sharded chunk's drift from JAX's sharded scan within the port's
    one-process drift from JAX's one-device scan (or test_torch_scan.py's
    bound); and the port's sharding moves its metrics no more than the
    reference's sharding moves JAX's."""
    from tests.test_torch_scan import LOSS_RTOL_K

    one = metric_drift(ranks["one"]["metrics"], ranks["jax_one"][0])
    ref = metric_drift(ranks["jax"][0], ranks["jax_one"][0])
    for r in ranks["results"]:
        got = metric_drift(r["parity"]["metrics"], ranks["jax"][0])
        own = metric_drift(r["parity"]["metrics"], ranks["one"]["metrics"])
        for name, drift in got.items():
            print(f"{name}: sharded vs JAX sharded {drift:.3e}, one "
                  f"process vs JAX one device {one[name]:.3e}; JAX sharded "
                  f"vs JAX one device {ref[name]:.3e}, sharded vs one "
                  f"process {own[name]:.3e}")
            assert drift <= max(LOSS_RTOL_K, DRIFT_RATIO * one[name]), name
            assert own[name] <= ref[name], name


def test_sharded_joint_parameters_match_jax(ranks):
    from tests.test_torch_scan import REL_L2_DELTA
    from tests.test_torch_train_step import leaves

    want = dict(leaves(ranks["jax"][1]))
    before = dict(leaves(ranks["before"]))
    got = [dict(leaves(r["parity"]["trainable"])) for r in ranks["results"]]
    assert got[0].keys() == want.keys()
    for name, w in want.items():
        assert np.array_equal(got[0][name], got[1][name]), name
        np.testing.assert_allclose(got[0][name], w, rtol=0,
                                   atol=2 * float(LRS.sum()), err_msg=name)
    drift = change_drift(got[0], want, before)
    one_process = dict(leaves(ranks["one"]["trainable"]))
    one = change_drift(one_process, dict(leaves(ranks["jax_one"][1])),
                       before)
    ref = change_drift(want, dict(leaves(ranks["jax_one"][1])), before)
    own = change_drift(got[0], one_process, before)
    print(f"parameters' change: sharded vs JAX sharded {drift:.3e}, one "
          f"process vs JAX one device {one:.3e}; JAX sharded vs JAX one "
          f"device {ref:.3e}, sharded vs one process {own:.3e}")
    assert drift <= max(REL_L2_DELTA, DRIFT_RATIO * one)
    assert own <= ref


def rel_l2(got, want) -> float:
    num = sum(float(np.sum((g - w) ** 2)) for g, w in zip(got, want))
    den = sum(float(np.sum(w ** 2)) for w in want)
    return (num / den) ** 0.5


def test_the_first_gradient_sits_at_a_discontinuity_of_the_detectors(
        ranks):
    """The port's first-step gradient (Adam's first mu, a tenth of it)
    against JAX's agrees to GRAD_REL_L2 over all leaves; and moving the
    stack by one ulp moves the port's own gradient at least half as far,
    in the leaf where the two packages differ most too: that leaf's
    gradient jumps under a rounding-level change of the input."""
    held = ranks["held"]
    names = [n for n, _ in held["first_mu"]]
    port = [m for _, m in held["first_mu"]]
    nudged = [m for _, m in ranks["nudged"]["first_mu"]]
    jax_mu = held["jax_first_mu"]
    gap, jump = rel_l2(port, jax_mu), rel_l2(nudged, port)
    # The input BatchNorm's gradient is zero but for rounding.
    leaf_gap = {n: rel_l2([p], [j]) for n, p, j in zip(names, port, jax_mu)
                if "input_bn" not in n}
    worst = max(leaf_gap, key=leaf_gap.get)
    i = names.index(worst)
    leaf_jump = rel_l2([nudged[i]], [port[i]])
    print(f"first gradient: port vs JAX {gap:.3e}, port nudged one ulp vs "
          f"port {jump:.3e}; in {worst} {leaf_gap[worst]:.3e} and "
          f"{leaf_jump:.3e}")
    assert gap <= GRAD_REL_L2
    assert jump >= gap / 2
    assert leaf_jump >= leaf_gap[worst] / 2


def test_holding_the_entries_whose_update_sign_differs_removes_the_drift(
        ranks):
    """With the entries whose parameter ends a step more than lr / 2 from
    JAX's set to JAX's (parameter and moments), few a step, the port's K
    steps stay within test_torch_scan.py's tolerances of JAX's scan."""
    from tests.test_torch_scan import LOSS_RTOL_K, REL_L2_DELTA
    from tests.test_torch_train_step import leaves

    held = ranks["held"]
    metrics, counts = held["metrics"], held["held"]
    entries = sum(m.size for _, m in held["first_mu"])
    drift = metric_drift(metrics, ranks["jax_one"][0])
    change = change_drift(dict(leaves(held["trainable"])),
                          dict(leaves(ranks["jax_one"][1])),
                          dict(leaves(ranks["before"])))
    print(f"held entries a step {counts} of {entries}; drift then "
          + ", ".join(f"{n} {v:.3e}" for n, v in drift.items())
          + f"; parameters' change {change:.3e}")
    assert len(counts) == K and 0 < max(counts) <= HELD_SHARE * entries
    for name, value in drift.items():
        assert value <= LOSS_RTOL_K, name
    assert change <= REL_L2_DELTA
    np.testing.assert_array_equal(metrics["loss"][0],
                                  ranks["one"]["metrics"]["loss"][0])


def test_sharded_joint_chunk_is_the_one_process_chunk(ranks):
    """The sharding adds rounding only: the two ranks' chunk against the
    port's chunk on the whole stack in one process, same inputs."""
    from tests.test_torch_train_step import leaves

    want = ranks["one"]
    before = dict(leaves(ranks["before"]))
    one = dict(leaves(want["trainable"]))
    for r in ranks["results"]:
        for name, w in want["metrics"].items():
            np.testing.assert_allclose(r["parity"]["metrics"][name], w,
                                       rtol=SHARDED_RTOL, err_msg=name)
        got = dict(leaves(r["parity"]["trainable"]))
        num = sum(float(np.sum((got[n] - w) ** 2)) for n, w in one.items())
        den = sum(float(np.sum((w - before[n]) ** 2))
                  for n, w in one.items())
        assert den > 0 and (num / den) ** 0.5 <= SHARDED_REL_L2


if __name__ == "__main__":
    child(*sys.argv[1:])
