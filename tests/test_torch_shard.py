"""The micrograph stack sharded over the ranks of a mesh, against the JAX
package's sharding.

Rank r of D holds rows ``[r n_l, (r+1) n_l)`` of the stack zero-padded to
``D n_l`` rows, ``n_l = ceil(N / D)`` (`parallel/mesh.py:shard_stack`), as
JAX's `shard_stack` places them on its devices; each rank cuts the crops
of the images it holds (`owned_crops`, exact zeros elsewhere) and a sum
over the ranks gives every crop.  Here the D ranks are virtual (one
process, no group) and their crops are summed in turn; the JAX side runs
`steps._sharded_patch_gather` on D of the 8 host devices that
`tests/conftest.py` forces.  Over N = 3 images (so 2 ranks hold one zero
row, 8 ranks five), the summed crops equal JAX's bit for bit, centred with
W flips (the joint plane) and at corners (the denoise plane), and equal
the one-card gather.  ``np.array_equal`` treats -0.0 and +0.0 as equal: a
-0.0 pixel comes back +0.0 from the sum, as from JAX's psum.

Beside them: each rank's shard against JAX's, the trainer's device
budget (a card's times the ranks) against JAX's, and the lazy placement
of both device planes: nothing is on the device before first use, and
`shard_over` places only the rank's rows.
"""

import numpy as np
import pytest
import torch

from spr_pick_tpu_torch.parallel.mesh import (Mesh, owned_crops, shard_rows,
                                              shard_stack)

N, H, W = 3, 40, 56
B = 16
CROP = 16


def host_stack():
    stack = np.random.RandomState(0).randn(N, H, W).astype(np.float32)
    stack[1, :8, :8] = -0.0
    return stack


def draws(centered, seed=1):
    """B global draws: image, y, x (centres or corners) and flip bits."""
    rng = np.random.RandomState(seed)
    flat = rng.randint(0, N, B).astype(np.int32)
    lo = CROP // 2 if centered else 0
    ys = rng.randint(lo, H - CROP + lo + 1, B).astype(np.int32)
    xs = rng.randint(lo, W - CROP + lo + 1, B).astype(np.int32)
    flips = (rng.rand(B) < 0.5).astype(np.int32)
    if not centered:
        flips[:] = 0
    return flat, ys, xs, flips


def virtual_mesh(d, r):
    return Mesh(size=d, rank=r, device=torch.device("cpu"))


def summed_crops(stack, d, centered, flat, ys, xs, flips):
    """The crops each of ``d`` virtual ranks owns, summed over the ranks."""
    total = None
    for r in range(d):
        local, offset = shard_stack(stack, virtual_mesh(d, r))
        part = owned_crops(local, offset, flat, ys, xs,
                           flips if centered else None, CROP, centered)
        total = part if total is None else total + part
    return total.numpy()


def jax_sharded_crops(devices, d, stack, centered, flat, ys, xs, flips):
    import jax
    import jax.numpy as jnp

    from spr_pick_tpu.parallel.mesh import make_mesh
    from spr_pick_tpu.parallel.mesh import shard_stack as jshard_stack
    from spr_pick_tpu.steps import _sharded_patch_gather

    mesh = make_mesh(d, devices=devices)
    gather = jax.jit(_sharded_patch_gather(mesh, "data", CROP, centered))
    out = gather(jshard_stack(stack, mesh), *(jnp.asarray(a) for a in
                                              (flat, ys, xs, flips)))
    return np.asarray(out)


@pytest.mark.parametrize("centered", [True, False],
                         ids=["centred_flips", "corners"])
@pytest.mark.parametrize("d", [2, 8])
def test_summed_owned_crops_equal_jax_sharded_gather(cpu_mesh_devices, d,
                                                     centered):
    stack = host_stack()
    args = draws(centered)
    got = summed_crops(stack, d, centered, *args)
    want = jax_sharded_crops(cpu_mesh_devices, d, stack, centered, *args)
    assert got.shape == want.shape == (B, CROP, CROP)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
    # ... and the one-card gather from the whole stack.
    assert np.array_equal(got, summed_crops(stack, 1, centered, *args))
    assert set(args[0]) == set(range(N))


def test_owned_crops_are_zero_where_the_rank_holds_no_image():
    """A rank cuts only the crops of its own rows; the others are exact
    zeros, whatever the clamped row index read."""
    stack = host_stack()
    flat, ys, xs, flips = draws(True)
    for d in (2, 8):
        for r in range(d):
            local, offset = shard_stack(stack, virtual_mesh(d, r))
            crops = owned_crops(local, offset, flat, ys, xs, flips, CROP,
                                True).numpy()
            own = (flat >= offset) & (flat < offset + local.shape[0])
            assert not crops[~own].any()
            half = CROP // 2
            for b in np.flatnonzero(own):
                y, x = ys[b] - half, xs[b] - half
                want = stack[flat[b], y:y + CROP, x:x + CROP]
                assert np.array_equal(crops[b], want[:, ::-1] if flips[b]
                                      else want)


@pytest.mark.parametrize("d,rows,offsets", [
    (1, 3, [0]), (2, 2, [0, 2]), (3, 1, [0, 1, 2]),
    (8, 1, [0, 1, 2, 3, 4, 5, 6, 7]),
])
def test_shard_stack_places_jax_s_shards(cpu_mesh_devices, d, rows, offsets):
    """Each rank's rows and offset, and its shard equal to the one JAX's
    `shard_stack` puts on device r: the images, then zero rows."""
    from spr_pick_tpu.parallel.mesh import make_mesh
    from spr_pick_tpu.parallel.mesh import shard_stack as jshard_stack

    stack = host_stack()
    jax_stack = jshard_stack(stack, make_mesh(d, devices=cpu_mesh_devices))
    jax_shards = sorted(jax_stack.addressable_shards,
                        key=lambda s: s.index[0].start or 0)
    assert jax_stack.shape[0] == d * rows
    for r in range(d):
        local, offset = shard_stack(stack, virtual_mesh(d, r))
        assert (offset, local.shape[0]) == (offsets[r], rows)
        assert shard_rows(N, d, r) == (offset, rows)
        assert local.dtype == torch.float32
        assert local.shape == (rows, H, W)
        assert np.array_equal(local.numpy(), np.asarray(jax_shards[r].data))
        real = max(0, min(rows, N - offset))
        assert np.array_equal(local[:real].numpy(),
                              stack[offset:offset + real])
        assert not local[real:].numpy().any()


@pytest.mark.parametrize("budget", [None, 1 << 20])
@pytest.mark.parametrize("d", [1, 2, 8])
def test_device_budget_is_a_card_s_times_the_ranks(cpu_mesh_devices,
                                                   monkeypatch, d, budget):
    from spr_pick_tpu.parallel.mesh import make_mesh
    from spr_pick_tpu.train import _device_data_budget as jax_budget
    from spr_pick_tpu_torch.train import _device_data_budget

    if budget is None:
        monkeypatch.delenv("SPR_DEVICE_DATA_BUDGET", raising=False)
    else:
        monkeypatch.setenv("SPR_DEVICE_DATA_BUDGET", str(budget))
    got = _device_data_budget(virtual_mesh(d, 0))
    assert got == jax_budget(make_mesh(d, devices=cpu_mesh_devices))
    assert got == d * (budget or 4 << 30)
    assert _device_data_budget() == jax_budget() == (budget or 4 << 30)


@pytest.fixture(scope="module")
def joint_dataset(tmp_path_factory):
    from spr_pick_tpu_torch.data.micrograph import MicrographDataset
    from tests.test_e2e import make_synthetic_dataset

    tmp = tmp_path_factory.mktemp("shard")
    images, coords = make_synthetic_dataset(tmp, np.random.RandomState(4),
                                            n_images=3, size=256,
                                            n_particles=4)
    return MicrographDataset(images, coords, radius=3, crop=64, bb=24,
                             verbose=False)


def denoise_dataset():
    rng = np.random.RandomState(5)
    return [rng.rand(h, w).astype(np.float32)
            for h, w in ((48, 64), (64, 40), (30, 30))]


def pipelines(joint_dataset):
    from spr_pick_tpu_torch.data.micrograph import DevicePatchPipeline
    from spr_pick_tpu_torch.data.patches import DeviceDenoisePipeline
    from spr_pick_tpu_torch.params import NoiseAlgorithm

    return {
        "joint": lambda: DevicePatchPipeline(joint_dataset, crop=64,
                                             device="cpu"),
        "denoise": lambda: DeviceDenoisePipeline(
            denoise_dataset(), 32, NoiseAlgorithm.NOISE_TO_VOID, "gauss25",
            device="cpu"),
    }


@pytest.mark.parametrize("plane", ["joint", "denoise"])
def test_planes_place_nothing_before_first_use(joint_dataset, plane):
    """As JAX `tests/test_parallel.py` holds its planes: nothing on the
    device after construction; `shard_over` places only the rank's rows,
    straight from the host, and drops the host stack; without a mesh the
    first use places the whole stack.  A placed stack is not resharded."""
    make = pipelines(joint_dataset)[plane]
    whole = make()
    assert whole.stack._dev is None and whole.stack._host is not None
    full = whole.images_dev
    assert full.shape[0] == N and whole.stack._host is None
    assert whole.stack.offset == 0
    for d, r in ((2, 0), (2, 1), (8, 5)):
        pipe = make()
        assert pipe.stack._dev is None
        pipe.shard_over(virtual_mesh(d, r))
        assert pipe.stack._host is None
        offset, rows = shard_rows(N, d, r)
        local = pipe.images_dev
        assert local.shape == (rows,) + tuple(full.shape[1:])
        assert pipe.stack.offset == offset
        real = max(0, min(rows, N - offset))
        assert torch.equal(local[:real], full[offset:offset + real])
        assert not local[real:].any()
    with pytest.raises(RuntimeError, match="already on the device"):
        whole.shard_over(virtual_mesh(2, 0))


def test_padded_stack_builds_only_the_rows_asked_for():
    from spr_pick_tpu_torch.data.micrograph import PaddedStack

    images = denoise_dataset()
    stack = PaddedStack(images)
    assert stack.shape == (3, 64, 64) and stack.nbytes == 3 * 64 * 64 * 4
    rows = stack[1:3]
    assert rows.shape == (2, 64, 64) and rows.dtype == np.float32
    assert np.array_equal(rows[0, :64, :40], images[1])
    assert not rows[0, :, 40:].any()
    assert np.array_equal(rows[1, :30, :30], images[2])
    assert stack[3:4].shape == (0, 64, 64)
