"""K1 on an NVIDIA GPU: the CUDA kernel against its plain PyTorch version,
the oracle and the wrapper's checks.  (The main path on the card is driven
by chip_smoke.py.)

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
    rows = nms_cuda.library.max_rows(0)
    with pytest.raises(ValueError, match="row-max cache"):
        k1(torch.zeros(1, rows + 1, 1, device=cuda), 2, 0.0, 4)

