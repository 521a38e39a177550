"""The port's trainer on the CPU, against the JAX package's.

On the synthetic manifest of `tests.test_e2e` (full-width model, float32,
batch 4, so the flip-TTA forward is folded):

  * interval firing: both trainers' loops run with a stub step (no
    compile) at a batch of 12, which divides none of the intervals; the
    eval, print and snapshot events must come at the same iterations, and
    the run dirs must carry the same `NNNNN-train-<config>` name;
  * a run writes `training_jt/model_{iter:08d}.training` at each snapshot
    boundary and `final-<config>.wt` at the end, where the JAX package
    puts them;
  * resuming from the middle snapshot gives the uninterrupted run's
    weights, BatchNorm statistics, Adam moments and next sampler draws,
    bit for bit (one process, one CPU), also with a validation pass at
    the snapshot's iteration;
  * SIGTERM during training: a snapshot at the next boundary, no
    `final-*.wt`;
  * a `.training` written by the JAX package (its `save_training`, with an
    optax state after one `tx.update` and its sampler and flip states)
    resumes in the port with its weights, Adam count and moments, iteration
    and data-plane state; and a `.training` written by the port resumes in
    the JAX trainer with the same trees.
"""

import os
import shutil
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from spr_pick_tpu import cfg as jcfg_mod
from spr_pick_tpu.params import ConfigValue as JCV
from spr_pick_tpu.params import NoiseAlgorithm as JNA
from spr_pick_tpu.params import NoiseValue as JNV
from spr_pick_tpu_torch import cfg as cfg_mod
from spr_pick_tpu_torch import train as train_mod
from spr_pick_tpu_torch.params import ConfigValue, NoiseAlgorithm, NoiseValue
from spr_pick_tpu_torch.train import DenoiserTrainer, resume_run
from spr_pick_tpu_torch.utils import checkpoint as ckpt
from tests.test_e2e import make_synthetic_dataset


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def assert_trees_equal(a, b):
    a, b = dict(leaves(a)), dict(leaves(b))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trainer")
    return make_synthetic_dataset(tmp, np.random.RandomState(0), n_images=2,
                                  size=256, n_particles=4)


def make_cfg(iterations=16, batch=4, eval_interval=8, print_interval=4,
             snapshot=8, jax=False):
    cv, na, nv = ((JCV, JNA, JNV) if jax else
                  (ConfigValue, NoiseAlgorithm, NoiseValue))
    c = (jcfg_mod if jax else cfg_mod).base()
    c[cv.ALGORITHM] = na.SELFSUPERVISED_DENOISING
    c[cv.NOISE_STYLE] = "gauss"
    c[cv.NOISE_VALUE] = nv.UNKNOWN_CONSTANT
    c[cv.COMPUTE_DTYPE] = "f32"
    c[cv.ITERATIONS] = iterations
    c[cv.TRAIN_MINIBATCH_SIZE] = batch
    c[cv.EVAL_INTERVAL] = eval_interval
    c[cv.PRINT_INTERVAL] = print_interval
    c[cv.SNAPSHOT_INTERVAL] = snapshot
    return c


def trainer(dataset, runs_dir, validate=True, **kw):
    images, coords = dataset
    t = DenoiserTrainer(make_cfg(**kw), alpha=0.75, tau=0.05,
                        runs_dir=str(runs_dir), device="cpu")
    t.set_train_data(images)
    t.set_train_label(coords)
    if validate:
        t.set_test_data(images)
        t.set_test_label(coords)
    return t


# ---------------------------------------------------------------------------
# Interval firing and naming, against the JAX loop with stub steps
# ---------------------------------------------------------------------------

INTERVALS = dict(iterations=100, batch=12, eval_interval=40,
                 print_interval=32, snapshot=40)


def jax_events(dataset, tmp_path, monkeypatch):
    from spr_pick_tpu.train import DenoiserTrainer as JTrainer

    images, coords = dataset
    monkeypatch.setenv("SPR_HOST_JOINT_DATA", "1")
    t = JTrainer(make_cfg(jax=True, **INTERVALS), alpha=0.75, tau=0.05,
                 runs_dir=str(tmp_path / "jax"))
    for setter, path in ((t.set_train_data, images),
                         (t.set_train_label, coords),
                         (t.set_test_data, images),
                         (t.set_test_label, coords)):
        setter(path)
    events = []
    t.denoiser = object()
    t._rng_key = jax.random.PRNGKey(0)
    t._train_step = lambda state, batch, rng, lr: (
        state, {"loss": np.zeros((12, 1), np.float32)})
    t._evaluate = lambda **kw: events.append(("eval", t.iteration))
    t.snapshot = lambda **kw: events.append(
        ("snapshot", t.iteration, kw.get("output_name")))
    t.write_metrics = lambda **kw: events.append(("print", t.iteration))
    t.train()
    return events, os.path.basename(t.run_dir_path)


def port_events(dataset, tmp_path, monkeypatch):
    t = trainer(dataset, tmp_path / "port", **INTERVALS)
    events = []

    class Stub:
        def train(self, mode=True):
            return self

    t.denoiser = Stub()
    t._train_generator = None
    monkeypatch.setattr(train_mod, "train_step", lambda *a, **k: {
        "loss": torch.zeros(12, 1)})
    # Chunks of K > 1 steps go through the K-step chunk function.
    monkeypatch.setattr(train_mod, "make_train_scan", lambda *a, **k: (
        lambda state, images, flat, *rest: {"loss": torch.zeros(len(flat))}))
    t.validate = lambda: events.append(("eval", t.iteration))
    t.snapshot = lambda **kw: events.append(
        ("snapshot", t.iteration, kw.get("output_name")))
    t.write_metrics = lambda **kw: events.append(("print", t.iteration))
    t.train()
    return events, os.path.basename(t.run_dir_path)


def test_intervals_fire_like_jax(dataset, tmp_path, monkeypatch):
    want, want_dir = jax_events(dataset, tmp_path, monkeypatch)
    got, got_dir = port_events(dataset, tmp_path, monkeypatch)
    assert got == want
    assert got_dir == want_dir == "00000-train-ssdn-gauss-iter100-0.75-0.05-joint"
    # Crossings, not exact hits: 12 divides none of 32 and 40.
    assert [e[1] for e in got if e[0] == "print"] == [0, 36, 72, 96]
    assert ("snapshot", 108, "final-ssdn-gauss-iter108-0.75-0.05-joint.wt") \
        in got


# ---------------------------------------------------------------------------
# Real runs on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def run_a(dataset, tmp_path_factory):
    """The uninterrupted run: 16 iterations, snapshots at 8 and 16, a
    validation pass at 0 and 8."""
    t = trainer(dataset, tmp_path_factory.mktemp("runs_a"))
    t.train()
    return t


def test_snapshots_and_final_where_jax_puts_them(run_a):
    run = run_a.run_dir_path
    assert os.path.basename(run) == \
        "00000-train-ssdn-gauss-iter16-0.75-0.05-joint"
    assert sorted(os.listdir(os.path.join(run, "training_jt"))) == [
        "model_00000000.training", "model_00000008.training",
        "model_00000016.training"]
    assert os.path.isfile(os.path.join(
        run, "final-ssdn-gauss-iter16-0.75-0.05-joint.wt"))
    assert os.path.isfile(os.path.join(run, "log.txt"))
    assert os.path.isfile(os.path.join(run, "scalars.jsonl"))
    assert any(f.startswith("events.out.tfevents") for f in os.listdir(run))
    val = sorted(os.listdir(os.path.join(run, "val_imgs_joint")))
    assert "mic0_00000008_scores.txt" in val
    assert "mic0_00000008_pred_tar.png" in val
    state = ckpt.load(os.path.join(run, "training_jt",
                                   "model_00000016.training"))
    assert state["iteration"] == 16 and int(state["opt_state"][0]) == 4
    assert run_a.train_state.step == 4


def test_resume_from_the_middle_is_bit_exact(run_a, tmp_path):
    run_b = str(tmp_path / os.path.basename(run_a.run_dir_path))
    shutil.copytree(run_a.run_dir_path, run_b)
    t = resume_run(run_b, iteration=8, device="cpu")
    assert t.iteration == 8 and t.train_state.step == 2
    t.train()
    a = ckpt.load(os.path.join(run_a.run_dir_path, "training_jt",
                               "model_00000016.training"))
    b = ckpt.load(os.path.join(run_b, "training_jt",
                               "model_00000016.training"))
    for key in ("trainable", "static"):
        assert_trees_equal(a[key], b[key])
    assert int(a["opt_state"][0]) == int(b["opt_state"][0]) == 4
    for x, y in zip(a["opt_state"][1:], b["opt_state"][1:]):
        assert_trees_equal(x, y)
    np.testing.assert_array_equal(
        t.train_sampler.sample_batch(16), run_a.train_sampler.sample_batch(16))


def test_sigterm_snapshots_and_stops(dataset, tmp_path, monkeypatch):
    t = trainer(dataset, tmp_path, validate=False, iterations=10 ** 6,
                print_interval=8, snapshot=10 ** 6)
    make_scan = train_mod.make_train_scan
    calls = []

    def signalling_scan(*a, **k):
        scan = make_scan(*a, **k)

        def chunk_then_signal(state, images, flat, *rest):
            calls.append(len(flat))
            if len(calls) == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return scan(state, images, flat, *rest)

        return chunk_then_signal

    monkeypatch.setattr(train_mod, "make_train_scan", signalling_scan)
    t.train()
    run = t.run_dir_path
    # Chunks run to the next print boundary (8 = 2 steps): the signal in the
    # second chunk stops the run at 16.
    assert t.iteration == 16 and calls == [2, 2]
    assert sorted(os.listdir(os.path.join(run, "training_jt"))) == [
        "model_00000000.training", "model_00000016.training"]
    assert not [f for f in os.listdir(run) if f.endswith(".wt")]
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL


def test_jax_written_training_resumes_in_the_port(dataset, tmp_path):
    from spr_pick_tpu.data.micrograph import HostPatchPipeline as JHost
    from spr_pick_tpu.data.micrograph import MicrographDataset as JDataset
    from spr_pick_tpu.data.sampler import StratifiedCoordinateSampler as JS
    from spr_pick_tpu.utils import checkpoint as jckpt

    images, coords = dataset
    c = make_cfg(jax=True)
    c[JCV.TRAIN_DATA_PATH], c[JCV.TRAIN_LABEL_PATH] = images, coords
    jcfg_mod.infer(c)
    # Weights from the port's init, an optax state after one update.
    port = trainer(dataset, tmp_path / "src", validate=False)
    port.new_target()
    trainable, static = port.denoiser.variables()
    tx = optax.scale_by_adam(b1=0.9, b2=0.99, eps=1e-8)
    rng = np.random.RandomState(0)
    grads = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32)),
        trainable)
    _, opt_state = tx.update(grads, tx.init(trainable), trainable)
    jds = JDataset(images, coords, radius=3, crop=64, bb=24, verbose=False)
    sampler = JS(list(jds.targets), balance=0.1, size=16 * 4,
                 random=np.random.RandomState(0))
    pipe = JHost(jds, crop=64)
    pipe.batch(sampler.sample_batch(4))
    run = tmp_path / "runs" / "00007-train-ssdn-gauss-iter16-0.75-0.05-joint"
    jckpt.save_training(
        str(run / "training_jt" / "model_00000004.training"), trainable,
        static, opt_state, c, "joint", 4,
        rng_key=jax.random.PRNGKey(3),
        extra={"data_state": {"sampler": sampler.state_dict(),
                              "pipeline": pipe.state_dict()}})

    t = resume_run(str(run), device="cpu")
    assert t.iteration == 4 and t.train_state.step == 1
    got_tr, got_st = t.denoiser.variables()
    assert_trees_equal(got_tr, trainable)
    assert_trees_equal(got_st, static)
    count, mu, nu = t.opt_state()
    assert int(count) == 1 == t.train_state.opt.count
    assert_trees_equal(mu, jax.tree_util.tree_map(np.asarray, opt_state.mu))
    assert_trees_equal(nu, jax.tree_util.tree_map(np.asarray, opt_state.nu))
    t.trainset, t.train_sampler, t.patch_pipeline = t.train_data()
    t.load_data_state_dict(t._pending_data_state)
    packed = sampler.sample_batch(4)
    np.testing.assert_array_equal(t.train_sampler.sample_batch(4), packed)
    np.testing.assert_array_equal(t.patch_pipeline.batch(packed)["inp"],
                                  np.asarray(pipe.batch(packed)["inp"]))


def test_port_written_training_resumes_in_jax(run_a):
    from spr_pick_tpu.train import resume_run as j_resume_run

    j = j_resume_run(run_a.run_dir_path, iteration=8)
    state = ckpt.load(os.path.join(run_a.run_dir_path, "training_jt",
                                   "model_00000008.training"))
    assert j.iteration == 8 and int(j.train_state.step) == 2
    assert_trees_equal(jax.tree_util.tree_map(np.asarray,
                                              j.train_state.trainable),
                       state["trainable"])
    count, mu, nu = state["opt_state"]
    assert int(j.train_state.opt_state.count) == int(count) == 2
    assert_trees_equal(jax.tree_util.tree_map(np.asarray,
                                              j.train_state.opt_state.mu), mu)
    assert j.alpha == 0.75 and j.tau == 0.05
    assert j._pending_data_state["sampler"]["history"].sum() >= 0


def test_load_weights_starts_a_fresh_optimizer(run_a):
    """`load_weights` (train.py:1481-1500): the `.wt`'s variables, step 0,
    zero Adam moments."""
    wt = os.path.join(run_a.run_dir_path,
                      "final-ssdn-gauss-iter16-0.75-0.05-joint.wt")
    t = DenoiserTrainer(None, device="cpu")
    t.load_weights(wt)
    state = ckpt.load(wt)
    got_tr, got_st = t.denoiser.variables()
    assert_trees_equal(got_tr, state["trainable"])
    assert_trees_equal(got_st, state["static"])
    assert t.train_state.step == 0 and t.train_state.opt.count == 0
    assert all(float(m.abs().max()) == 0 for m in t.train_state.opt.mu)
    assert (t.alpha, t.tau) == (0.75, 0.05)


def test_data_plane_falls_back_to_the_host_past_the_budget(dataset, tmp_path,
                                                           monkeypatch):
    """Within SPR_DEVICE_DATA_BUDGET the stack goes to the device plane;
    past it the trainer warns and cuts the crops on the host
    (train.py:309-326)."""
    from spr_pick_tpu_torch.data.micrograph import (DevicePatchPipeline,
                                                    HostPatchPipeline)

    t = trainer(dataset, tmp_path, validate=False)
    assert isinstance(t.train_data()[2], DevicePatchPipeline)
    monkeypatch.setenv("SPR_DEVICE_DATA_BUDGET", "1000")
    assert isinstance(t.train_data()[2], HostPatchPipeline)
