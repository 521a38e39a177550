"""K1 on an NVIDIA GPU: the CUDA kernel against its plain PyTorch version,
the oracle and the wrapper's checks, including the cases where the tiled
design can go wrong (tile corners and edges, radii 0 and 40, maps smaller
than a tile, +-0.0, strided crops, the largest maps and T = 64).  (The main
path on the card is driven by chip_smoke.py.)

Every test here needs a CUDA device and ``nvcc`` (K1 is built from
``spr_pick_tpu_torch/csrc/nms.cu`` at first use) and skips elsewhere.  The
file imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from spr_pick_tpu_torch.ops import nms, nms_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: K1 is a CUDA kernel with no CPU mode")
    return torch.device("cuda")


def _maps(case, rng):
    if case == "random":
        return rng.rand(2, 256, 256), None, 0.02
    if case == "plateaus":
        return np.floor(rng.rand(1, 200, 160) * 4) / 4, None, 0.2
    if case == "constant":
        return np.full((1, 128, 128), 0.5), None, 0.02
    if case == "saturated":
        p = 1 / (1 + np.exp(-8 * rng.randn(1, 192, 192)))
        return np.clip(p, 1e-4, 1 - 1e-4), None, 0.02
    if case == "suppressed":
        return rng.rand(1, 128, 128), rng.rand(1, 128, 128) < 0.2, 0.1
    return rng.rand(3, 37, 53), None, 0.1  # odd sizes, a batch of 3


@pytest.mark.parametrize("case", ["random", "plateaus", "constant",
                                  "saturated", "suppressed", "odd"])
def test_k1_equals_plain_version(cuda, case):
    maps, sup, thr = _maps(case, np.random.RandomState(0))
    x = torch.from_numpy(maps.astype(np.float32)).to(cuda)
    s = None if sup is None else torch.from_numpy(sup).to(cuda)
    kept = x.clone()
    before = nms_cuda.greedy_nms_cuda.launches
    got = nms_cuda.greedy_nms(x, 6, thr, 4096, s)
    torch.cuda.synchronize()
    assert nms_cuda.greedy_nms_cuda.launches == before + 1
    want = nms_cuda.greedy_nms_plain(x, 6, thr, 4096, s)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[2].min()) > 0
    assert torch.equal(x, kept)  # the caller's maps are left alone
    # The CPU copy of the same maps gives the same picks.
    cpu = nms_cuda.greedy_nms(x.cpu(), 6, thr, 4096,
                              None if s is None else s.cpu())
    for g, w in zip(got, cpu):
        assert torch.equal(g.cpu(), w)


def test_k1_cap_retry_matches_the_oracle(cuda):
    x = np.random.RandomState(3).rand(64, 64).astype(np.float32)
    s_ref, c_ref = nms.non_maximum_suppression_np(x, 3, threshold=0.02)
    s, c = nms.nms_to_host(torch.from_numpy(x).to(cuda), 3, threshold=0.02,
                           max_peaks=32)
    np.testing.assert_array_equal(s, s_ref)
    np.testing.assert_array_equal(c, c_ref)


def test_k1_refuses_what_it_cannot_take(cuda):
    k1 = nms_cuda.greedy_nms_cuda
    with pytest.raises(TypeError, match="float32"):
        k1(torch.zeros(1, 8, 8, dtype=torch.float64, device=cuda), 2, 0.0, 4)
    with pytest.raises(ValueError, match=r"\(B, H, W\)"):
        k1(torch.zeros(8, 8, device=cuda), 2, 0.0, 4)
    with pytest.raises(ValueError, match="unit column stride"):
        k1(torch.zeros(1, 8, 9, device=cuda).transpose(1, 2), 2, 0.0, 4)
    # 60000^2 needs a 445 KB tile-key table even at T = 256: refused before
    # anything is allocated (the map is a broadcast row, row stride 0).
    huge = torch.zeros(1, 1, 60000, device=cuda).expand(1, 60000, 60000)
    with pytest.raises(ValueError, match="tile-key table"):
        k1(huge, 2, 0.0, 4)


def _planted(rng, h, w, cuda, n=300, background=0.015):
    """A map below the 0.02 threshold but for ``n`` planted peaks, so that
    the plain version, which syncs once a pick, stays fast."""
    g = torch.Generator(device=cuda).manual_seed(int(rng.randint(1 << 30)))
    x = torch.rand(1, h, w, device=cuda, generator=g) * background
    ys, xs = rng.randint(0, h, n), rng.randint(0, w, n)
    x[0, torch.from_numpy(ys).to(cuda), torch.from_numpy(xs).to(cuda)] = (
        torch.from_numpy(rng.rand(n).astype(np.float32) * 0.9 + 0.05).to(cuda))
    return x


def _tile_case(case, rng):
    """(maps, threshold, radius) of a case where tiling can go wrong."""
    if case == "tile corners":
        x = rng.rand(1, 128, 160) * 0.01
        x[0, 31, 31] = x[0, 32, 32] = 0.9   # a tie across a tile corner
        x[0, 31, 64] = x[0, 32, 63] = 0.8   # a tie across a tile edge
        x[0, 63, 95] = 0.7
        return x, 0.02, 15
    if case == "radius 0":
        return rng.rand(2, 48, 80), 0.5, 0
    if case == "radius 40":   # the disk spans up to 4 x 4 tiles
        return rng.rand(1, 300, 260), 0.02, 40
    if case == "5x7":
        return rng.rand(1, 5, 7), 0.1, 2
    if case == "1x300":
        return rng.rand(2, 1, 300), 0.1, 3
    if case == "100x70":
        return rng.rand(1, 100, 70), 0.1, 6
    # threshold -inf on negative values with both +0.0 and -0.0
    x = -np.abs(rng.randn(1, 96, 100))
    x[rng.rand(*x.shape) < 0.05] = 0.0
    x[rng.rand(*x.shape) < 0.05] = -0.0
    return x, float("-inf"), 4


def _equal_to_plain(maps, radius, thr, max_peaks=4096):
    kept = maps.clone()
    before = nms_cuda.greedy_nms_cuda.launches
    got = nms_cuda.greedy_nms(maps, radius, thr, max_peaks)
    torch.cuda.synchronize()
    assert nms_cuda.greedy_nms_cuda.launches == before + 1
    want = nms_cuda.greedy_nms_plain(maps, radius, thr, max_peaks)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(maps, kept)
    assert int(got[2].min()) > 0
    return got


@pytest.mark.parametrize("case", ["tile corners", "radius 0", "radius 40",
                                  "5x7", "1x300", "100x70", "+-0 at -inf"])
def test_k1_tiling_equals_plain_version(cuda, case):
    maps, thr, radius = _tile_case(case, np.random.RandomState(4))
    _equal_to_plain(torch.from_numpy(maps.astype(np.float32)).to(cuda),
                    radius, thr)


def test_k1_reads_the_strided_crop(cuda):
    # Picker._heatmaps passes outputs[DETECT][:, :h, :w, 0].
    rng = np.random.RandomState(5)
    full = torch.from_numpy(rng.rand(2, 96, 128, 1).astype(np.float32)).to(cuda)
    crop = full[:, :90, :100, 0]
    got = _equal_to_plain(crop, 6, 0.1)
    for g, w in zip(got, nms_cuda.greedy_nms(crop.contiguous(), 6, 0.1, 4096)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("edge", [64, 128, 256])
@pytest.mark.parametrize("radius", [15, 40])
def test_k1_every_tile_edge(cuda, monkeypatch, edge, radius):
    # Maps that need T = 128 or 256 are 16384 px and more; force the edge
    # on a small map instead, to run each build of the kernel.
    monkeypatch.setattr(nms_cuda, "tile_edge", lambda h, w, r, optin: edge)
    maps = np.random.RandomState(8).rand(2, 600, 700)
    _equal_to_plain(torch.from_numpy(maps.astype(np.float32)).to(cuda),
                    radius, 0.02)


@pytest.mark.parametrize("shape, edge", [((4096, 5760), 32), ((8192, 8192), 64)])
def test_k1_largest_maps(cuda, shape, edge):
    optin = nms_cuda.library.smem_optin(0)
    assert nms_cuda.tile_edge(*shape, 15, optin) == edge
    maps = _planted(np.random.RandomState(6), *shape, cuda)
    _equal_to_plain(maps, 15, 0.02)


# ---------------------------------------------------------------------------
# The denoise data plane's device functions (no kernel of their own: torch
# ops that must give the CPU's values for the same draws)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 64), (30, 37)])
def test_manipulate_torch_on_the_card_equals_the_cpu(cuda, shape):
    from spr_pick_tpu_torch.data import n2v

    g = torch.Generator().manual_seed(0)
    x = torch.rand((16,) + shape, generator=g)
    draws = [torch.rand((16,) + n2v.grid_shape(*shape), generator=g)
             for _ in range(3)]
    want = n2v.manipulate_torch(x, *draws)
    got = n2v.manipulate_torch(x.to(cuda), *(d.to(cuda) for d in draws))
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("style", ["gauss25", "gauss10_50", "poisson10_50"])
def test_add_style_torch_on_the_card_equals_the_cpu(cuda, style):
    from spr_pick_tpu_torch.data.noise import add_style_torch

    g = torch.Generator().manual_seed(1)
    x = torch.rand((16, 64, 64), generator=g)
    u = torch.rand((16, 1, 1), generator=g)
    n = (torch.randn(x.shape, generator=g) if style.startswith("gauss")
         else torch.poisson(torch.ones(x.shape), generator=g))
    want = add_style_torch(x, style, uniform=u, noise=n)
    got = add_style_torch(x.to(cuda), style, uniform=u.to(cuda),
                          noise=n.to(cuda))
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
