"""The host joint data plane and the planes' `augment` switch, against the
JAX package.

`SPR_HOST_JOINT_DATA=1` makes the JAX trainer build `HostPatchPipeline`
without trying the device plane (`spr_pick_tpu/train.py:309-325`) and step
one batch at a time (`_can_scan`).  On the synthetic manifest of
`tests.test_e2e` (the JAX heatmaps drawn with the numpy loop, as in
`tests/test_torch_patch_pipeline.py`), under the switch:

  * the port's trainer builds `HostPatchPipeline`, no chunk function, and
    calls `train_step` once a batch;
  * a real port run (float32, batch 4, 4 steps) feeds the batches that the
    JAX trainer, its step stubbed, feeds, bit for bit, and ends with the
    same sampler position and `data_state_dict()`;
  * a port run resumed from its snapshot at step 2 feeds the
    uninterrupted run's last batches and ends with its data state;
  * `train start --mesh 2 --device cpu` (two gloo ranks) takes the host
    plane too, one step a batch;
  * any value other than "1" leaves the switch unset.

Both planes with ``augment=False`` give the JAX planes' batches and
`state_dict()` (all-zero flips, no draw from the flip `RandomState`), and
``augment=True`` is unchanged; a chunk's (K, B) flips without augment are
zeros, drawn from nothing.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from spr_pick_tpu import native
from spr_pick_tpu.data import micrograph as jmic
from spr_pick_tpu_torch import train as train_mod
from spr_pick_tpu_torch.data import micrograph as mic
from spr_pick_tpu_torch.data.sampler import StratifiedCoordinateSampler
from spr_pick_tpu_torch.train import DenoiserTrainer, resume_run
from tests.test_e2e import make_synthetic_dataset
from tests.test_torch_trainer import make_cfg

REPO = Path(__file__).resolve().parent.parent
CROP = 64
B = 4
ITERS = 16           # 4 steps at batch 4
SNAPSHOT = 8         # the resumed run starts at step 2
RUN = dict(iterations=ITERS, batch=B, eval_interval=0, print_interval=4,
           snapshot=SNAPSHOT)


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("host_plane")
    return make_synthetic_dataset(tmp, np.random.RandomState(0), n_images=2,
                                  size=256, n_particles=4)


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)


def assert_states_equal(got, want):
    got, want = dict(leaves(got)), dict(leaves(want))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def as_np(batch):
    return {k: np.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# The trainer under SPR_HOST_JOINT_DATA=1
# ---------------------------------------------------------------------------

def jax_run(manifest, runs_dir):
    """The JAX trainer under the switch, its step stubbed: the batches it
    feeds and its data state at the end."""
    from spr_pick_tpu.train import DenoiserTrainer as JTrainer

    images, coords = manifest
    t = JTrainer(make_cfg(jax=True, **RUN), alpha=0.75, tau=0.05,
                 runs_dir=str(runs_dir))
    t.set_train_data(images)
    t.set_train_label(coords)
    batches = []

    def step(state, batch, rng, lr):
        batches.append(as_np(batch))
        return state, {"loss": np.zeros((B, 1), np.float32)}

    t.denoiser = object()
    t._rng_key = jax.random.PRNGKey(0)
    t._train_step = step
    t.snapshot = lambda **kw: None
    t.write_metrics = lambda **kw: None
    t.train()
    assert isinstance(t.patch_pipeline, jmic.HostPatchPipeline)
    return dict(batches=batches, sampler=t.train_sampler.state_dict(),
                data=t.data_state_dict())


def port_run(monkeypatch, train):
    """Run ``train`` (a port trainer's `train`, or a resumed one's),
    recording each `train_step`'s batch; a chunk function must not be
    built."""
    batches = []
    real_step = train_mod.train_step

    def step(state, batch, *args, **kw):
        batches.append({k: v.numpy().copy() for k, v in batch.items()})
        return real_step(state, batch, *args, **kw)

    def no_chunk(*args, **kw):
        raise AssertionError("a chunk function was built for the host plane")

    with monkeypatch.context() as mp:
        mp.setattr(train_mod, "train_step", step)
        mp.setattr(train_mod, "make_train_scan", no_chunk)
        t = train()
    return t, batches


@pytest.fixture(scope="module")
def runs(manifest, tmp_path_factory):
    images, coords = manifest
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPR_HOST_JOINT_DATA", "1")
        mp.setattr(native, "available", lambda: False)
        want = jax_run(manifest, tmp_path_factory.mktemp("jax_runs"))

        def start():
            t = DenoiserTrainer(make_cfg(**RUN), alpha=0.75, tau=0.05,
                                runs_dir=str(tmp_path_factory.mktemp("runs")),
                                device="cpu")
            t.set_train_data(images)
            t.set_train_label(coords)
            t.train()
            return t

        def resume():
            t = resume_run(run_dir, iteration=SNAPSHOT, device="cpu")
            t.train()
            return t

        t, batches = port_run(mp, start)
        run_dir = t.run_dir_path
        resumed, resumed_batches = port_run(mp, resume)
    return dict(jax=want, port=t, batches=batches, resumed=resumed,
                resumed_batches=resumed_batches)


def test_the_switch_takes_the_host_plane_one_step_a_batch(runs):
    t = runs["port"]
    assert isinstance(t.patch_pipeline, mic.HostPatchPipeline)
    assert t.patch_pipeline.augment
    assert t._scan is None and t._build_scan() is None
    assert len(runs["batches"]) == ITERS // B == t.train_state.step
    for b in runs["batches"]:
        assert b["inp"].shape == (B, CROP, CROP, 1)
    with open(os.path.join(t.run_dir_path, "log.txt")) as f:
        text = f.read()
    assert "joint data plane: HostPatchPipeline" in text
    assert "graphed chunks" not in text


def test_batches_equal_the_jax_trainers(runs):
    want, got = runs["jax"]["batches"], runs["batches"]
    assert len(got) == len(want) == ITERS // B
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["inp"], w["inp"])
        np.testing.assert_array_equal(g["target"], w["target"])


def test_sampler_and_data_state_equal_the_jax_trainers(runs):
    t = runs["port"]
    assert_states_equal(t.train_sampler.state_dict(), runs["jax"]["sampler"])
    assert_states_equal(t.data_state_dict(), runs["jax"]["data"])


def test_resume_under_the_switch_continues_the_batches(runs):
    t = runs["resumed"]
    assert isinstance(t.patch_pipeline, mic.HostPatchPipeline)
    assert t._scan is None
    got = runs["resumed_batches"]
    want = runs["jax"]["batches"][SNAPSHOT // B:]
    assert len(got) == len(want) == (ITERS - SNAPSHOT) // B
    for g, u, w in zip(got, runs["batches"][SNAPSHOT // B:], want):
        for k in ("inp", "target"):
            np.testing.assert_array_equal(g[k], w[k])
            np.testing.assert_array_equal(g[k], u[k])
    assert_states_equal(t.data_state_dict(), runs["jax"]["data"])


def test_the_switch_under_a_mesh_steps_eagerly_on_the_host_plane(
        manifest, tmp_path):
    """`train start --mesh 2 --device cpu` (two gloo ranks) under the
    switch: the host plane on every rank, one step a batch, no chunk."""
    images, coords = manifest
    runs = tmp_path / "runs"
    env = dict(os.environ, SPR_HOST_JOINT_DATA="1", OMP_NUM_THREADS="2",
               PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "spr_pick_tpu_torch", "train", "start", "-a",
         "ssdn", "-n", "gauss", "--noise_value", "const", "-t", images, "-l",
         coords, "--alpha", "0.8", "--tau", "0.01", "--iterations", "16",
         "--train_batch_size", "4", "--print_interval", "8",
         "--checkpoint_interval", "16", "--runs_dir", str(runs), "--device",
         "cpu", "--mesh", "2"],
        cwd=str(REPO), env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    (run,) = runs.iterdir()
    text = (run / "log.txt").read_text()
    assert "joint data plane: HostPatchPipeline" in text
    assert "graphed chunks" not in text
    assert (run / "final-ssdn-gauss-iter16-0.8-0.01-joint.wt").is_file()


@pytest.mark.parametrize("value", ["0", "true", ""])
def test_any_other_value_leaves_the_switch_unset(manifest, tmp_path,
                                                 monkeypatch, value):
    images, coords = manifest
    monkeypatch.setenv("SPR_HOST_JOINT_DATA", value)
    t = DenoiserTrainer(make_cfg(**RUN), alpha=0.75, tau=0.05,
                        runs_dir=str(tmp_path), device="cpu")
    t.set_train_data(images)
    t.set_train_label(coords)
    _, _, pipe = t.train_data()
    assert isinstance(pipe, mic.DevicePatchPipeline) and pipe.augment


# ---------------------------------------------------------------------------
# The planes' augment switch
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def planes(manifest):
    images, coords = manifest
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "available", lambda: False)
        jds = jmic.MicrographDataset(images, coords, radius=3, train=True,
                                     crop=CROP, bb=24, verbose=False)
    ds = mic.MicrographDataset(images, coords, radius=3, crop=CROP, bb=24,
                               verbose=False)
    sampler = StratifiedCoordinateSampler(
        list(ds.targets), balance=0.1, size=10 ** 5,
        random=np.random.RandomState(1))
    return jds, ds, [sampler.sample_batch(16) for _ in range(3)]


@pytest.mark.parametrize("augment", [False, True])
@pytest.mark.parametrize("plane", ["DevicePatchPipeline",
                                   "HostPatchPipeline"])
def test_planes_equal_jax_with_and_without_augment(planes, plane, augment):
    jds, ds, packed = planes
    jp = getattr(jmic, plane)(jds, crop=CROP, augment=augment)
    tp = getattr(mic, plane)(ds, crop=CROP, augment=augment, device="cpu")
    untouched = tp.state_dict()
    flipped = 0
    for p in packed:
        want, got = as_np(jp.batch(p)), tp.batch(p)
        np.testing.assert_array_equal(got["inp"].numpy(), want["inp"])
        np.testing.assert_array_equal(got["target"].numpy(), want["target"])
        straight = np.stack([ds.train_item(int(i))[0] for i in p])[..., None]
        flipped += int((got["inp"].numpy() != straight).any(axis=(1, 2, 3))
                       .sum())
        assert_states_equal(tp.state_dict(), jp.state_dict())
    if augment:
        assert flipped > 0
    else:
        assert flipped == 0
        assert_states_equal(tp.state_dict(), untouched)


def test_a_chunks_flips_without_augment_are_zeros_drawn_from_nothing(planes):
    _, ds, _ = planes
    off = mic.DevicePatchPipeline(ds, crop=CROP, augment=False, device="cpu")
    on = mic.DevicePatchPipeline(ds, crop=CROP, device="cpu")
    before = off.state_dict()
    flips = off.flips((3, 16))
    assert flips.shape == (3, 16) and flips.dtype == np.int32
    assert not flips.any()
    assert_states_equal(off.state_dict(), before)
    # With augment, the (K, B) draw is the numbers of K (B,) draws.
    rng = np.random.RandomState(0)
    want = (rng.rand(3, 16) < 0.5).astype(np.int32)
    np.testing.assert_array_equal(on.flips((3, 16)), want)
    assert torch.equal(
        off.gather(*off.decode(planes[2][0]), flips[0]),
        on.gather(*on.decode(planes[2][0]), np.zeros(16, np.int32)))
