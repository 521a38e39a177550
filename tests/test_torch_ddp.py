"""Data parallelism on the CPU: two gloo ranks against one process, and
against the JAX package.

Two processes join a gloo group on 127.0.0.1 at a free port (spawned as
`tests/test_multiprocess.py` spawns its children, with a timeout each:
this file is also their program).  At global batch 4 (2 a rank) on 64^2
crops, float32, from the same seeded weights and the same generator seed:

  * one joint step (folded and sequential flip-TTA) and one ssdn
    denoise-only step equal the port's single-process step at batch 4:
    loss terms within 1e-6 relative (the flip-consistency term, a mean of
    squared differences of two detector outputs whose relative error is
    the detector's over that difference, within 1e-7 absolute), gradients
    within 1e-5 relative L2, BatchNorm running statistics within 1e-6.
    The parameters after Adam are within 1e-6 of the single process's Adam
    update on the rank's (global) gradient; against the single-process
    step itself they are within two learning rates, element by element:
    Adam's first update is g / (|g| + 1e-8), so a rounding-level move of a
    gradient entry at a U-Net max-pool tie (the gradient goes to the other
    entry of the window, `tests/test_torch_train_step.py`) flips that
    entry's update.  Both ranks end with identical parameters, bit for bit;
  * each of them equals the JAX single-device step on the same draws
    (the JAX sample noise swapped for the port's generator draws inside
    the traced step, the flip axis the port drew), within the tolerances
    of `tests/test_torch_train_step.py`.

The trainer's device data planes, sharded over the two ranks (the joint
plane on three 256^2 micrographs, the ssdn and n2v denoise planes on three
96x128 ones): each rank holds ceil(3/2) = 2 stack rows, its batches are
the one-process plane's rows exactly, and a per-card budget between a
rank's share and the whole stack keeps the device plane on the two ranks,
where one process falls back to the host plane.

Two steps of the sharded K-step chunk functions (`make_train_scan_sharded`,
`make_denoise_scan_sharded`; eager under a mesh) on the two ranks equal
the chunk on the whole stack in one process: the first step's metrics
within the step's tolerances, the ranks bit for bit alike, the parameters
within two learning rates a step.

The evaluator over 3 micrographs on 2 ranks gives the single-process n and
PSNR, and writes each micrograph's files once, by the rank that owns it.
`tiled_dense_apply` over two CPU replicas equals the one-device stitch bit
for bit, and ``train start --mesh 2 --device cpu`` trains on two ranks,
then resumes on one.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from spr_pick_tpu_torch import cfg as cfg_mod
from spr_pick_tpu_torch import weights
from spr_pick_tpu_torch.denoiser import Denoiser
from spr_pick_tpu_torch.params import (ConfigValue, NoiseAlgorithm,
                                       NoiseValue, PipelineOutput)
from spr_pick_tpu_torch.steps import TrainState, make_optimizer, train_step
from spr_pick_tpu_torch.utils import checkpoint as ckpt

REPO = Path(__file__).resolve().parent.parent
B = 4
PATCH = 64
SEED = 7
LR = 1e-4
ALPHA, TAU = 0.75, 0.05
TARGET = np.array([0.9, -1.0, 0.0, -1.0], np.float32)
RTOL_LOSS = 1e-6
ATOL_AUG = 1e-7
GRAD_L2 = 1e-5
ATOL_BN = 1e-6
ATOL_ADAM = 1e-6
TIMEOUT = 120


# ---------------------------------------------------------------------------
# What both the ranks and the single process run
# ---------------------------------------------------------------------------

def step_cfg(kind):
    c = cfg_mod.base()
    c[ConfigValue.ALGORITHM] = NoiseAlgorithm.SELFSUPERVISED_DENOISING
    c[ConfigValue.NOISE_STYLE] = "gauss" if kind == "joint" else "gauss25"
    c[ConfigValue.NOISE_VALUE] = NoiseValue.UNKNOWN_CONSTANT
    c[ConfigValue.COMPUTE_DTYPE] = "f32"
    c[ConfigValue.TRAIN_MINIBATCH_SIZE] = B
    return c


def global_batch(kind):
    rng = np.random.RandomState(1)
    batch = {"inp": torch.from_numpy(
        rng.rand(B, PATCH, PATCH, 1).astype(np.float32))}
    if kind == "joint":
        batch["target"] = torch.from_numpy(TARGET)
    return batch


def one_step(wt, kind, fold, mesh=None):
    """One train step from the weights in ``wt`` on the global batch (this
    rank's slice of it under ``mesh``); numpy results."""
    state = ckpt.load(wt)
    den = Denoiser(step_cfg(kind), mode=kind, device="cpu", mesh=mesh,
                   fold_tta=fold)
    den.load_variables(state["trainable"], state["static"])
    den.train()
    batch = global_batch(kind)
    if mesh is not None:
        batch = mesh.local(batch)
    ts = TrainState(step=0, denoiser=den, opt=make_optimizer(den))
    metrics = train_step(ts, batch, LR, ALPHA, TAU,
                         generator=torch.Generator().manual_seed(SEED))
    named = den.named_trainable()
    grads = weights.named_to_flax(
        (g, k, t.grad if t.grad is not None else torch.zeros_like(t))
        for g, k, t in named)
    after, static = den.variables()
    return dict(metrics={k: v.numpy() for k, v in metrics.items()},
                grads=grads, static=static, after=after)


def evaluate(wt, d, runs, mesh=None):
    """The evaluator over the 3-micrograph set in ``d``; its merged metrics
    and the artifact paths this process wrote."""
    from spr_pick_tpu_torch.eval import DenoiserEvaluator

    ev = DenoiserEvaluator(wt, runs_dir=str(runs), device="cpu", mesh=mesh)
    ev.set_test_data(str(d / "imgs.txt"))
    ev.set_test_label(str(d / "coords.txt"))
    ev.set_test_gt_data(str(d / "gt.txt"))
    ev.cfg[ConfigValue.NUM_EVAL] = 3
    ev.cfg[ConfigValue.TEST_MINIBATCH_SIZE] = 2
    written = []
    submit = ev._submit_export

    def recording(fn, *args):
        written.append(os.path.relpath(args[-1], str(runs)))
        submit(fn, *args)

    ev._submit_export = recording
    ev.evaluate()
    psnr = {k: (float(m.total), m.n) for k, m in ev.eval_history.items()
            if k != "n" and not m.empty()}
    return dict(n=ev.eval_history["n"], psnr=psnr, written=written)


CASES = {"joint_fold": ("joint", True), "joint_seq": ("joint", False),
         "ssdn": ("denoise", None)}
# Per-card budgets between a rank's share (2 of 3 rows) and the whole
# stack: 3 x 256^2 and 3 x 96 x 128 float32.
PLANE_BUDGET = {"joint": 600_000, "ssdn": 120_000, "n2v": 120_000}
PLANE_BATCHES = 3


def plane_batches(kind, d, mesh=None, budget=None):
    """The trainer's data plane for ``kind`` over the 3-image sets in
    ``d`` (under ``budget`` bytes a card, else the default): its class,
    the stack rows it holds, and PLANE_BATCHES global batches of B (this
    rank's rows under ``mesh``)."""
    from spr_pick_tpu_torch.train import DenoiserTrainer

    c = cfg_mod.base()
    c[ConfigValue.TRAIN_MINIBATCH_SIZE] = B
    if kind == "joint":
        c[ConfigValue.ALGORITHM] = NoiseAlgorithm.SELFSUPERVISED_DENOISING
        c[ConfigValue.NOISE_STYLE] = "gauss"
        c[ConfigValue.NOISE_VALUE] = NoiseValue.UNKNOWN_CONSTANT
    else:
        c[ConfigValue.ALGORITHM] = NoiseAlgorithm(kind)
        c[ConfigValue.NOISE_STYLE] = "gauss25"
        c[ConfigValue.TRAIN_PATCH_SIZE] = 32
    t = DenoiserTrainer(c, mode="joint" if kind == "joint" else "denoise",
                        runs_dir=str(d / "plane_runs"), device="cpu",
                        mesh=mesh)
    if kind == "joint":
        t.set_train_data(str(d / "plane" / "train_images.txt"))
        t.set_train_label(str(d / "plane" / "train_coords.txt"))
    else:
        t.set_train_data(str(d / "mics"))
    saved = os.environ.pop("SPR_DEVICE_DATA_BUDGET", None)
    if budget is not None:
        os.environ["SPR_DEVICE_DATA_BUDGET"] = str(budget)
    try:
        t.trainset, t.train_sampler, t.patch_pipeline = t.train_data()
    finally:
        os.environ.pop("SPR_DEVICE_DATA_BUDGET", None)
        if saved is not None:
            os.environ["SPR_DEVICE_DATA_BUDGET"] = saved
    stack = getattr(t.patch_pipeline, "stack", None)
    return dict(plane=type(t.patch_pipeline).__name__,
                rows=None if stack is None else stack.images_dev.shape[0],
                batches=[t.next_batch(B) for _ in range(PLANE_BATCHES)])


CHUNK_K = 2


def one_chunk(wt, kind, mesh=None):
    """CHUNK_K steps of the K-step chunk function from the weights in
    ``wt`` on a 3-image stack (`make_train_scan_sharded` /
    `make_denoise_scan_sharded` on this rank's shard under ``mesh``,
    `make_train_scan` / `make_denoise_scan` on the whole stack without);
    numpy results."""
    from spr_pick_tpu_torch.parallel.mesh import shard_stack
    from spr_pick_tpu_torch.steps import (make_denoise_scan,
                                          make_denoise_scan_sharded,
                                          make_train_scan,
                                          make_train_scan_sharded)

    rng = np.random.RandomState(3)
    stack = rng.rand(3, 96, 128).astype(np.float32)
    shape = (CHUNK_K, B)
    flat = rng.randint(3, size=shape).astype(np.int32)
    half = PATCH // 2 if kind == "joint" else 0
    ys = rng.randint(half, 96 - PATCH + half + 1, size=shape).astype(np.int32)
    xs = rng.randint(half, 128 - PATCH + half + 1, size=shape).astype(
        np.int32)
    lrs = np.full(CHUNK_K, LR, np.float32)
    state = ckpt.load(wt)
    den = Denoiser(step_cfg(kind), mode=kind, device="cpu", mesh=mesh,
                   fold_tta=True if kind == "joint" else None)
    den.load_variables(state["trainable"], state["static"])
    den.train()
    ts = TrainState(step=0, denoiser=den, opt=make_optimizer(den))
    gens = [torch.Generator().manual_seed(SEED + i) for i in range(2)]
    if mesh is None:
        images = torch.from_numpy(stack)
    else:
        images = shard_stack(stack, mesh)[0]
    if kind == "joint":
        args = (flat, ys, xs, rng.randint(2, size=shape).astype(np.int32),
                rng.choice(TARGET, shape), lrs, gens[0])
        scan = (make_train_scan(den, ALPHA, TAU, PATCH) if mesh is None else
                make_train_scan_sharded(den, ALPHA, TAU, PATCH, mesh))
    else:
        algo = step_cfg(kind)[ConfigValue.ALGORITHM]
        args = (flat, ys, xs, lrs, *gens)
        scan = (make_denoise_scan(den, ALPHA, TAU, PATCH, algo, "gauss25")
                if mesh is None else make_denoise_scan_sharded(
                    den, ALPHA, TAU, PATCH, algo, "gauss25", mesh))
    metrics = scan(ts, images, *args)
    after, static = den.variables()
    return dict(metrics={k: v.numpy() for k, v in metrics.items()},
                after=after, static=static, count=ts.opt.count)


def rank_work(mesh, d):
    """What each rank computes, in one process start: the step of every
    case, the sharded data planes and the evaluator pass (``d`` holds
    their inputs)."""
    d = Path(d)
    out = {case: one_step(str(d / f"{kind}.wt"), kind, fold, mesh)
           for case, (kind, fold) in CASES.items()}
    out["planes"] = {kind: plane_batches(kind, d, mesh, budget)
                     for kind, budget in PLANE_BUDGET.items()}
    out["eval"] = evaluate(str(d / "joint.wt"), d, d / "ranks", mesh)
    out["chunks"] = {kind: one_chunk(str(d / f"{kind}.wt"), kind, mesh)
                     for kind in ("joint", "denoise")}
    if mesh.is_main:
        # The one-process chunks too, here on two threads, not in a test
        # worker beside five others.
        out["one_chunk"] = {kind: one_chunk(str(d / f"{kind}.wt"), kind)
                            for kind in ("joint", "denoise")}
    return out


def child(rank, size, port, out, d):
    from spr_pick_tpu_torch.parallel import mesh as mesh_mod

    mesh = mesh_mod.init(int(rank), int(size), "cpu",
                         f"tcp://127.0.0.1:{port}")
    try:
        result = rank_work(mesh, d)
    finally:
        mesh_mod.teardown(mesh)
    with open(out, "wb") as f:
        pickle.dump(result, f)


def run_ranks(d, size=2):
    """`rank_work` on ``size`` gloo ranks in child processes (two threads
    each, beside the test workers); their results."""
    from spr_pick_tpu_torch.parallel.mesh import free_port

    port = free_port()
    outs = [str(d / f"rank{r}.pkl") for r in range(size)]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(size), str(port), outs[r],
         str(d)], cwd=str(REPO), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(size)]
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
# The steps
# ---------------------------------------------------------------------------

def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def flat(tree):
    return np.concatenate([v.reshape(-1) for _, v in leaves(tree)])


def write_weights(path, kind):
    from tests.test_torch_models import randomize

    c = step_cfg(kind)
    den = Denoiser(c, mode=kind, device="cpu")
    randomize(den.model, seed=5)
    with torch.no_grad():
        den.l_params["estimated_sigma"].fill_(0.3)
    ckpt.save_weights(path, *den.variables(), c, kind)
    return path


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Weights for both modes and the 3-micrograph eval set, and what two
    gloo ranks computed from them."""
    from tests.test_e2e import make_synthetic_dataset

    d = tmp_path_factory.mktemp("ddp")
    for kind in ("joint", "denoise"):
        write_weights(str(d / f"{kind}.wt"), kind)
    write_eval_set(d)
    (d / "plane").mkdir()
    make_synthetic_dataset(d / "plane", np.random.RandomState(2), n_images=3,
                           size=256, n_particles=4)
    return dict(dir=d, results=run_ranks(d))


@pytest.fixture(scope="module", params=list(CASES))
def steps(request, ranks):
    kind, fold = CASES[request.param]
    wt = str(ranks["dir"] / f"{kind}.wt")
    return dict(case=request.param, kind=kind, fold=fold, wt=wt,
                ranks=[r[request.param] for r in ranks["results"]],
                single=one_step(wt, kind, fold))


def test_loss_terms_match_one_process(steps):
    want = steps["single"]["metrics"]
    for got in steps["ranks"]:
        assert got["metrics"].keys() == want.keys()
        for k, w in want.items():
            assert got["metrics"][k].shape == w.shape, k
            rtol, atol = (0, ATOL_AUG) if k == "aug_loss" else (RTOL_LOSS, 0)
            np.testing.assert_allclose(got["metrics"][k], w, rtol=rtol,
                                       atol=atol, err_msg=k)
    if steps["kind"] == "joint":
        assert want["loss"].shape == (B, 1)


def test_gradients_match_one_process(steps):
    want = flat(steps["single"]["grads"])
    for got in steps["ranks"]:
        rel = np.linalg.norm(flat(got["grads"]) - want) / np.linalg.norm(want)
        assert rel <= GRAD_L2, rel


def test_batchnorm_running_stats_match_one_process(steps):
    want = dict(leaves(steps["single"]["static"]))
    before = dict(leaves(ckpt.load(steps["wt"])["static"]))
    assert len(want) == 18
    for got in steps["ranks"]:
        got = dict(leaves(got["static"]))
        assert got.keys() == want.keys()
        for name, w in want.items():
            np.testing.assert_allclose(got[name], w, rtol=0, atol=ATOL_BN,
                                       err_msg=name)
    assert any(np.any(want[k] != before[k]) for k in want)


def test_params_after_adam_match_one_process(steps):
    from spr_pick_tpu_torch.steps import ScaleByAdam

    start = [torch.from_numpy(v.copy())
             for _, v in leaves(ckpt.load(steps["wt"])["trainable"])]
    want = flat(steps["single"]["after"])
    for got in steps["ranks"]:
        # The single process's Adam on this rank's gradient.
        params = [t.clone() for t in start]
        opt = ScaleByAdam(params)
        for t, (_, g) in zip(params, leaves(got["grads"])):
            t.grad = torch.from_numpy(g.copy())
        opt.step(LR)
        np.testing.assert_allclose(
            flat(got["after"]), np.concatenate(
                [t.numpy().ravel() for t in params]), rtol=0, atol=ATOL_ADAM)
        assert np.abs(flat(got["after"]) - want).max() <= 2 * LR + ATOL_ADAM


def test_ranks_hold_identical_parameters(steps):
    r0, r1 = steps["ranks"]
    for a, b in ((r0["after"], r1["after"]), (r0["static"], r1["static"])):
        for (name, x), (_, y) in zip(leaves(a), leaves(b)):
            assert np.array_equal(x, y), name


def jax_step(steps):
    """The JAX single-device step from the same weights on the draws the
    port's generator made (replayed in its order: the flip, then the noise
    of the folded 2B batch; ssdn: the B sample noises)."""
    import jax
    import jax.numpy as jnp

    from spr_pick_tpu import cfg as jcfg_mod
    from spr_pick_tpu.denoiser import Denoiser as JDenoiser
    from spr_pick_tpu.params import ConfigValue as JCV
    from spr_pick_tpu.params import NoiseAlgorithm as JNA
    from spr_pick_tpu.params import NoiseValue as JNV
    from tests.test_torch_train_step import KEYS, flip_p

    kind = steps["kind"]
    gen = torch.Generator().manual_seed(SEED)
    key = 0

    def normal(n):
        return torch.randn((n, PATCH, PATCH, 1), generator=gen).numpy()

    if kind == "joint":
        w_flip = float(torch.rand((), generator=gen)) <= 0.5
        key = KEYS["w_flip" if w_flip else "h_flip"]
        assert (flip_p(key) <= 0.5) == w_flip
        draws = [normal(2 * B)] if steps["fold"] else [normal(B), normal(B)]
    else:
        draws = [normal(B)]
    j = jcfg_mod.base()
    j[JCV.ALGORITHM] = JNA.SELFSUPERVISED_DENOISING
    j[JCV.NOISE_STYLE] = step_cfg(kind)[ConfigValue.NOISE_STYLE]
    j[JCV.NOISE_VALUE] = JNV.UNKNOWN_CONSTANT
    j[JCV.COMPUTE_DTYPE] = "f32"
    j[JCV.TRAIN_MINIBATCH_SIZE] = B
    jden = JDenoiser(j, mode=kind, fold_tta=steps["fold"])
    state = ckpt.load(steps["wt"])
    static = state["static"]
    g = global_batch(kind)
    batch = {k: jnp.asarray(v.numpy()) for k, v in g.items()}

    def loss_fn(tr):
        queue = list(draws)

        def fixed(k, shape, dtype=jnp.float32):
            got = queue.pop(0)
            assert got.shape == tuple(shape)
            return jnp.asarray(got, dtype)

        normal = jax.random.normal
        jax.random.normal = fixed
        try:
            if kind == "joint":
                return jden.joint_pipeline(tr, static, batch,
                                           jax.random.PRNGKey(key), ALPHA,
                                           TAU, train=True)
            return jden.run_pipeline(tr, static, batch,
                                     jax.random.PRNGKey(key), train=True)
        finally:
            jax.random.normal = normal

    (loss, (outs, bn)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(state["trainable"])
    return float(loss), outs, bn, grads


def test_ranks_match_the_jax_step(steps):
    from spr_pick_tpu.params import PipelineOutput as JPO
    from tests.test_torch_train_step import (ATOL_AUG, ATOL_BN as JATOL_BN,
                                             ATOL_REL, ATOL_ZERO_GRAD)
    from tests.test_torch_train_step import RTOL_LOSS as JRTOL

    loss, outs, bn, grads = jax_step(steps)
    for got in steps["ranks"]:
        m = got["metrics"]
        np.testing.assert_allclose(m["loss"], np.asarray(outs[JPO.LOSS]),
                                   rtol=JRTOL)
        np.testing.assert_allclose(m["loss"].mean(), loss, rtol=JRTOL)
        if steps["kind"] == "joint":
            for k, jk in (("denoise_loss", JPO.DENOISE_LOSS),
                          ("det_loss", JPO.DETECT_LOSS)):
                np.testing.assert_allclose(m[k], np.asarray(outs[jk]),
                                           rtol=JRTOL, err_msg=k)
            np.testing.assert_allclose(m["aug_loss"],
                                       float(outs[JPO.AUG_LOSS]), rtol=0,
                                       atol=ATOL_AUG)
        want = dict(leaves(grads))
        got_g = dict(leaves(got["grads"]))
        assert got_g.keys() == want.keys()
        for name, w in want.items():
            if not np.any(w):
                assert not np.any(got_g[name]), name
                continue
            atol = (ATOL_ZERO_GRAD if "/input_bn/" in name
                    else ATOL_REL * float(np.abs(w).max()))
            np.testing.assert_allclose(got_g[name], w, rtol=0, atol=atol,
                                       err_msg=name)
        want_bn = dict(leaves(bn))
        got_bn = dict(leaves(got["static"]["model"]))
        assert got_bn.keys() == want_bn.keys()
        for name, w in want_bn.items():
            np.testing.assert_allclose(got_bn[name], w, rtol=0,
                                       atol=JATOL_BN, err_msg=name)


def test_local_rows_split_the_global_draw():
    from spr_pick_tpu_torch.parallel.mesh import Mesh, MeshError

    mesh = Mesh(size=2, rank=1, device=torch.device("cpu"))
    t = torch.arange(8)
    assert mesh.local_rows(t).tolist() == [4, 5, 6, 7]
    # The folded flip-TTA noise: [primary B; flipped B], each split.
    assert mesh.local_rows(t, parts=2).tolist() == [2, 3, 6, 7]
    for rows, parts in ((5, 1), (6, 2)):
        with pytest.raises(MeshError, match="split evenly"):
            mesh.local_rows(torch.arange(rows), parts=parts)


@pytest.mark.parametrize("requested,device,cards,batch,want", [
    (None, "cpu", 0, 16, 1), (2, "cpu", 0, 16, 2), (None, None, 4, 16, 4),
    (None, None, 1, 16, 1), (2, None, 4, 16, 2), (3, None, 4, 16, 1),
    (4, None, 2, 16, "4 GPUs are needed, 2 visible"),
])
def test_mesh_size_resolves_as_the_jax_trainer(monkeypatch, requested,
                                               device, cards, batch, want):
    """None: every visible card (one rank on the CPU); a batch the size
    does not divide runs on one device; too few cards raise."""
    from spr_pick_tpu_torch.parallel import mesh

    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    if isinstance(want, str):
        with pytest.raises(mesh.MeshError, match=want):
            mesh.resolve_size(requested, device, batch)
    else:
        assert mesh.resolve_size(requested, device, batch) == want


# ---------------------------------------------------------------------------
# The sharded data planes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", list(PLANE_BUDGET))
def test_sharded_planes_give_the_one_process_batches(ranks, kind):
    """Each rank's batches from its shard of the stack (crops summed over
    the ranks, then its rows) equal the one-process plane's, bit for bit."""
    want = plane_batches(kind, ranks["dir"])
    assert want["plane"].startswith("Device") and want["rows"] == 3
    b = B // 2
    for r, res in enumerate(ranks["results"]):
        got = res["planes"][kind]
        assert len(got["batches"]) == len(want["batches"]) == PLANE_BATCHES
        for g, w in zip(got["batches"], want["batches"]):
            assert g.keys() == w.keys()
            for k in w:
                assert torch.equal(g[k], w[k][r * b: (r + 1) * b]), k


@pytest.mark.parametrize("kind", list(PLANE_BUDGET))
def test_each_rank_holds_its_share_within_the_card_budget(ranks, kind):
    """Under a per-card budget between a rank's share and the whole stack,
    two ranks keep the device plane and hold ceil(3/2) rows each; one
    process falls back to the host plane."""
    for res in ranks["results"]:
        got = res["planes"][kind]
        assert got["plane"].startswith("Device"), got["plane"]
        assert got["rows"] == 2
    one = plane_batches(kind, ranks["dir"], budget=PLANE_BUDGET[kind])
    assert not one["plane"].startswith("Device") and one["rows"] is None


# ---------------------------------------------------------------------------
# The evaluator, the tiled pass, the command
# ---------------------------------------------------------------------------

def write_eval_set(d):
    from spr_pick_tpu_torch.data import mrc

    rng = np.random.RandomState(0)
    (d / "mics").mkdir()
    (d / "gts").mkdir()
    rows, gt_rows = [], []
    for i in range(3):
        clean = rng.rand(96, 128).astype(np.float32)
        noisy = clean + 0.3 * rng.randn(96, 128).astype(np.float32)
        mrc.write(str(d / "mics" / f"m{i}.mrc"), noisy)
        mrc.write(str(d / "gts" / f"m{i}.mrc"), clean)
        rows.append(f"m{i}\t{d / 'mics' / f'm{i}.mrc'}")
        gt_rows.append(f"m{i}\t{d / 'gts' / f'm{i}.mrc'}")
    (d / "imgs.txt").write_text("image_name\tpath\n" + "\n".join(rows) + "\n")
    (d / "gt.txt").write_text("image_name\tpath\n" + "\n".join(gt_rows) + "\n")
    (d / "coords.txt").write_text(
        "image_name\tx_coord\ty_coord\nm0\t40\t50\nm1\t60\t70\nm2\t20\t20\n")


def test_evaluator_on_two_ranks_matches_one_process(ranks):
    d = ranks["dir"]
    want = evaluate(str(d / "joint.wt"), d, d / "single")
    ranks = [r["eval"] for r in ranks["results"]]
    assert want["n"] == 3
    assert sorted(want["psnr"]) == ["psnr_mu_out", "psnr_out"]
    written = [set(r["written"]) for r in ranks]
    assert [len(w) for w in written] == [len(r["written"]) for r in ranks]
    assert not written[0] & written[1]
    assert {w for s in written for w in s} == set(want["written"])
    names = {os.path.basename(p).split("_")[0] for p in written[1]}
    assert names == {"m1"}
    for r in ranks:
        assert r["n"] == want["n"]
        assert r["psnr"].keys() == want["psnr"].keys()
        for k, (total, n) in want["psnr"].items():
            assert r["psnr"][k][1] == n == 3
            np.testing.assert_allclose(r["psnr"][k][0], total, rtol=1e-12)


def test_tiled_pass_over_two_replicas_is_the_one_device_stitch(ranks):
    """A 96x160 micrograph tiled into six 96^2 windows (threshold and tile
    64, halo 16), dealt over two CPU replicas: the stitched maps and the
    picks equal the one-device pass bit for bit."""
    from spr_pick_tpu_torch.api import Picker

    image = np.random.RandomState(3).rand(96, 160).astype(np.float32)
    outs = []
    for kw in ({"device": "cpu"}, {"devices": ["cpu", "cpu"]}):
        picker = Picker(str(ranks["dir"] / "joint.wt"), border=0, **kw)
        ev = picker.evaluator
        ev.tile_eval_threshold, ev.tile_eval_size, ev.tile_eval_halo = \
            64, 64, 16
        assert ev.tiled(image.shape)
        assert len(ev._replicas) == len(kw.get("devices", [0])) - 1
        outputs = ev.forward([image], torch.Generator().manual_seed(0))
        outs.append((outputs, picker._nms(picker._heatmaps(
            outputs, image.shape)[0])))
    (one, picks_one), (two, picks_two) = outs
    assert one.keys() == two.keys() and PipelineOutput.DETECT in one
    for k in one:
        assert torch.equal(one[k], two[k]), k
    assert len(picks_one[0]) > 0
    for a, b in zip(picks_one, picks_two):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_train_command_on_two_cpu_ranks_then_resumed_on_one(tmp_path,
                                                          monkeypatch):
    from spr_pick_tpu_torch.cli import cli
    from tests.test_e2e import make_synthetic_dataset
    from tests.test_torch_cli_train import RUN, start_args

    dataset = make_synthetic_dataset(tmp_path, np.random.RandomState(1),
                                     n_images=2, size=256, n_particles=4)
    runs = tmp_path / "runs"
    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # each spawned rank's
    cli.start(start_args(dataset, runs, "--device", "cpu", "--mesh", "2"))
    run = runs / RUN
    assert sorted(os.listdir(runs)) == [RUN]
    assert sorted(os.listdir(run / "training_jt")) == [
        "model_00000000.training", "model_00000004.training",
        "model_00000008.training"]
    final = ckpt.load(str(run / "training_jt" / "model_00000008.training"))
    assert final["cfg"][ConfigValue.MESH_SHAPE] == 2
    assert final["iteration"] == 8
    log = (run / "log.txt").read_text()
    assert "TRAINING FINISHED" in log and "loss=" in log

    cli.start(["train", "resume", str(run), "--iteration", "4",
               "--device", "cpu", "--mesh", "1"])
    again = ckpt.load(str(run / "training_jt" / "model_00000008.training"))
    assert again["iteration"] == 8
    # One rank from the 2-rank snapshot at 4 takes the same global batches
    # and draws: the weights agree up to rounding, which Adam's first
    # steps magnify to at most a learning rate a step on tiny gradients.
    a, b = flat(again["trainable"]), flat(final["trainable"])
    assert np.abs(a - b).max() <= 4 * 2 * 1e-4
    assert np.median(np.abs(a - b)) <= 1e-6



@pytest.mark.parametrize("kind", ["joint", "denoise"])
def test_sharded_chunks_match_one_process(ranks, kind):
    """Two steps of the sharded chunk function on two gloo ranks (each
    holding 2 of the 3 stack rows, its rows of the batch, gradients
    averaged before Adam) against the chunk on the whole stack in one
    process: the first step's metrics within the step's tolerances, the
    ranks' parameters and BatchNorm statistics bit for bit equal, and the
    parameters within two learning rates a step of one process's (Adam's
    sign flips, `test_params_after_adam_match_one_process`; rank 0's child
    computes the one-process chunk)."""
    want = ranks["results"][0]["one_chunk"][kind]
    got = [r["chunks"][kind] for r in ranks["results"]]
    for g in got:
        assert g["count"] == want["count"] == CHUNK_K
        assert g["metrics"].keys() == want["metrics"].keys()
        for k, w in want["metrics"].items():
            assert g["metrics"][k].shape == w.shape == (CHUNK_K,), k
            rtol, atol = (0, ATOL_AUG) if k == "aug_loss" else (RTOL_LOSS, 0)
            np.testing.assert_allclose(g["metrics"][k][0], w[0], rtol=rtol,
                                       atol=atol, err_msg=k)
        assert np.abs(flat(g["after"]) - flat(want["after"])).max() <= \
            2 * CHUNK_K * LR + ATOL_ADAM
    for key in ("after", "static"):
        for (name, x), (_, y) in zip(leaves(got[0][key]),
                                     leaves(got[1][key])):
            assert np.array_equal(x, y), name


if __name__ == "__main__":
    child(*sys.argv[1:])
