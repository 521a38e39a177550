"""The port's training samplers draw the JAX package's packed indices,
exactly.

Same labels, seeds and call sequence into `spr_pick_tpu.data.sampler` and
`spr_pick_tpu_torch.data.sampler`: the packed-index ABI, the P/U
enumeration with its margins, the stratified draws (several groups, an
empty P stratum, a micrograph smaller than the margin frame, the default
size), ShuffledSampler reshuffles, and a `state_dict` round trip: a fresh
sampler of either package loaded with the other's state draws the same
next indices.
"""

import numpy as np
import pytest

from spr_pick_tpu.data import sampler as jsampler
from spr_pick_tpu_torch.data import sampler


def labels(seed, shape=(300, 320), n=6):
    rng = np.random.RandomState(seed)
    y = np.zeros(shape, np.uint8)
    for r, c in zip(rng.randint(80, shape[0] - 150, n),
                    rng.randint(80, shape[1] - 150, n)):
        y[r - 3:r + 4, c - 3:c + 4] = 1
    return y


GROUPS = {
    "two_groups": lambda: [[labels(0), labels(1)], [labels(2, (400, 300))]],
    "empty_p": lambda: [[labels(3), np.zeros((300, 300), np.uint8)],
                        [np.zeros((300, 300), np.uint8)]],
    "tiny_image": lambda: [[labels(4), np.zeros((100, 100), np.uint8)],
                           [np.zeros((100, 100), np.uint8)]],
}


def both(groups, balance=0.1, size=5000, seed=7):
    return (jsampler.StratifiedCoordinateSampler(
                groups(), balance=balance, size=size,
                random=np.random.RandomState(seed)),
            sampler.StratifiedCoordinateSampler(
                groups(), balance=balance, size=size,
                random=np.random.RandomState(seed)))


def test_pack_unpack_and_enumeration():
    assert sampler.pack_index(3, 17, 123456) == jsampler.pack_index(
        3, 17, 123456)
    h = np.array([sampler.pack_index(2, 5, 99), sampler.pack_index(0, 1, 7)])
    for got, want in zip(sampler.unpack_index(h), jsampler.unpack_index(h)):
        np.testing.assert_array_equal(got, want)
    ys = [labels(0), labels(1, (256, 400))]
    for got, want in zip(sampler.enumerate_pu_coordinates(ys),
                         jsampler.enumerate_pu_coordinates(ys)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", list(GROUPS))
@pytest.mark.parametrize("balance", [0.1, None])
def test_stratified_draws_equal_jax(case, balance):
    j, t = both(GROUPS[case], balance=balance)
    np.testing.assert_array_equal(t.weights, j.weights)
    for batch in (16, 16, 7, 400):
        np.testing.assert_array_equal(t.sample_batch(batch),
                                      j.sample_batch(batch))
    np.testing.assert_array_equal(t.history, j.history)


def test_default_size_equals_jax():
    j = jsampler.StratifiedCoordinateSampler(
        GROUPS["two_groups"](), balance=0.5, random=np.random.RandomState(1))
    t = sampler.StratifiedCoordinateSampler(
        GROUPS["two_groups"](), balance=0.5, random=np.random.RandomState(1))
    assert len(t) == len(j)
    np.testing.assert_array_equal(np.fromiter(iter(t), np.int64, 50),
                                  np.fromiter(iter(j), np.int64, 50))


def test_all_empty_raises_like_jax():
    groups = [[np.zeros((100, 100), np.uint8)]]
    with pytest.raises(ValueError, match="no usable coordinates"):
        jsampler.StratifiedCoordinateSampler(groups, size=10)
    with pytest.raises(ValueError, match="no usable coordinates"):
        sampler.StratifiedCoordinateSampler(groups, size=10)


def test_shuffled_sampler_replays_its_shuffles():
    x = np.arange(7, dtype=np.int64)
    j = jsampler.ShuffledSampler(x.copy(), seed=3)
    t = sampler.ShuffledSampler(x.copy(), seed=3)
    assert [next(t) for _ in range(20)] == [next(j) for _ in range(20)]
    state = t.state_dict()
    assert state == j.state_dict()
    fresh = sampler.ShuffledSampler(x.copy(), seed=3)
    fresh.load_state_dict(state)
    assert [next(fresh) for _ in range(9)] == [next(j) for _ in range(9)]
    with pytest.raises(ValueError, match="seed mismatch"):
        sampler.ShuffledSampler(x.copy(), seed=4).load_state_dict(state)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_state_dict_round_trip(direction):
    j, t = both(GROUPS["two_groups"])
    for _ in range(3):
        np.testing.assert_array_equal(t.sample_batch(333),
                                      j.sample_batch(333))
    src = j if direction == "jax_to_port" else t
    j2, t2 = both(GROUPS["two_groups"])
    dst = t2 if direction == "jax_to_port" else j2
    dst.load_state_dict(src.state_dict())
    want = src.sample_batch(500)
    np.testing.assert_array_equal(dst.sample_batch(500), want)
