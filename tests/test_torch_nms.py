"""K1's plain PyTorch version against the greedy oracle and the Pallas
kernel (interpret mode, as tests/test_nms_pallas.py runs it on the CPU).

Picks must match exactly: scores, coords (x, y) and count — including the
tie order on plateaus (highest flat index first), which decides the pick
SET on saturated maps.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spr_pick_tpu.ops.nms import non_maximum_suppression_np as jax_oracle
from spr_pick_tpu.ops.nms_pallas import non_maximum_suppression_pallas
from spr_pick_tpu_torch.ops import nms
from spr_pick_tpu_torch.ops.nms_cuda import greedy_nms, greedy_nms_plain


def _random(rng):
    return rng.rand(128, 128).astype(np.float32), 5, 0.3


def _plateaus(rng):
    return (rng.rand(96, 96) * 4).astype(np.int32).astype(np.float32) / 4, 5, 0.2


def _constant(rng):
    return np.full((64, 64), 0.5, np.float32), 5, 0.02


def _saturated(rng):
    # clamped_sigmoid output: large plateaus at exactly 1 - 1e-4.
    logits = rng.randn(80, 80).astype(np.float32) * 8
    p = 1.0 / (1.0 + np.exp(-logits))
    return np.clip(p, 1e-4, 1 - 1e-4).astype(np.float32), 6, 0.02


def _odd(rng):
    return rng.rand(37, 53).astype(np.float32), 4, 0.1


CASES = {"random": _random, "plateaus": _plateaus, "constant": _constant,
         "saturated": _saturated, "odd": _odd}


def _plain_one(x, radius, threshold, max_peaks=4096, suppressed=None):
    s, c, n = greedy_nms_plain(
        torch.from_numpy(x)[None], radius, threshold, max_peaks,
        None if suppressed is None else torch.from_numpy(suppressed)[None],
    )
    n = int(n[0])
    return s[0, :n].numpy(), c[0, :n].numpy(), s[0].numpy(), c[0].numpy()


def _pallas(x, radius, threshold, max_peaks=4096):
    s, c, n = non_maximum_suppression_pallas(
        jnp.asarray(x), radius, threshold, max_peaks, interpret=True
    )
    n = int(n)
    return np.asarray(s[:n]), np.asarray(c[:n])


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_oracle_and_pallas(case):
    x, radius, threshold = CASES[case](np.random.RandomState(0))
    s, c, s_full, c_full = _plain_one(x, radius, threshold)
    s_ref, c_ref = jax_oracle(x, radius, threshold=threshold)
    s_pl, c_pl = _pallas(x, radius, threshold)
    assert len(s) == len(s_ref) == len(s_pl) > 0
    np.testing.assert_array_equal(s, s_ref)
    np.testing.assert_array_equal(c, c_ref)
    np.testing.assert_array_equal(s, s_pl)
    np.testing.assert_array_equal(c, c_pl)
    # Slots past the count are zero, as in K1.
    assert not s_full[len(s):].any() and not c_full[len(s):].any()
    # The port's copy of the oracle is the JAX oracle.
    s_own, c_own = nms.non_maximum_suppression_np(x, radius, threshold)
    np.testing.assert_array_equal(s_own, s_ref)
    np.testing.assert_array_equal(c_own, c_ref)


def test_cap_and_threshold():
    x = np.zeros((64, 64), np.float32)
    x[10, 10] = 1.0
    x[40, 40] = 0.5
    x[50, 20] = 0.02  # not strictly above the threshold: never picked
    s, c, n = greedy_nms(torch.from_numpy(x)[None], 5, 0.02, 8)
    assert int(n[0]) == 2
    np.testing.assert_array_equal(s[0, :2].numpy(), [1.0, 0.5])
    np.testing.assert_array_equal(c[0, :2].numpy(), [[10, 10], [40, 40]])
    s1, c1, n1 = greedy_nms(torch.from_numpy(x)[None], 5, 0.02, 1)
    assert int(n1[0]) == 1 and float(s1[0, 0]) == 1.0


def test_suppressed_seeds():
    rng = np.random.RandomState(1)
    x = rng.rand(64, 64).astype(np.float32)
    sup = rng.rand(64, 64) < 0.2
    s, c, _, _ = _plain_one(x, 5, 0.1, suppressed=sup)
    s_ref, c_ref = jax_oracle(x, 5, threshold=0.1, suppressed=sup)
    s_pl, c_pl = _pallas(np.where(sup, -np.inf, x).astype(np.float32), 5, 0.1)
    np.testing.assert_array_equal(s, s_ref)
    np.testing.assert_array_equal(c, c_ref)
    np.testing.assert_array_equal(c, c_pl)
    # nms_to_host seeds the same way and leaves the caller's map alone.
    hm = torch.from_numpy(x.copy())
    s2, c2 = nms.nms_to_host(hm, 5, threshold=0.1, suppressed=sup)
    np.testing.assert_array_equal(c2, c_ref)
    assert torch.equal(hm, torch.from_numpy(x))


def test_batch_of_three():
    rng = np.random.RandomState(2)
    maps = rng.rand(3, 48, 56).astype(np.float32)
    maps[1] = (maps[1] * 3).astype(np.int32) / 3  # plateaus in one lane
    got = nms.nms_batch_to_host(torch.from_numpy(maps), 4, threshold=0.2,
                                max_peaks=512)
    for i in range(3):
        s_ref, c_ref = jax_oracle(maps[i], 4, threshold=0.2)
        np.testing.assert_array_equal(got[i][0], s_ref)
        np.testing.assert_array_equal(got[i][1], c_ref)


def test_auto_retry_past_the_cap(caplog):
    x = np.random.RandomState(3).rand(64, 64).astype(np.float32)
    s_ref, c_ref = jax_oracle(x, 3, threshold=0.02)
    assert 32 * 4 < len(s_ref) < 32 * 16  # needs 3 or 4 doublings from 32
    with caplog.at_level(logging.WARNING, logger="nms"):
        s, c = nms.nms_to_host(x, 3, threshold=0.02, max_peaks=32)
    np.testing.assert_array_equal(s, s_ref)
    np.testing.assert_array_equal(c, c_ref)
    assert "auto-retrying" in caplog.text
    # Past 4 doublings the list stays capped, with a warning.
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="nms"):
        s, _ = nms.nms_to_host(x, 3, threshold=0.02, max_peaks=4)
    assert len(s) == 64 and "DROPPED" in caplog.text
    np.testing.assert_array_equal(s, s_ref[:64])
