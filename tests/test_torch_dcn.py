"""The port's work-list sharding and metric-vector codec
(`spr_pick_tpu_torch/parallel/dcn.py`) against the JAX package's
(`spr_pick_tpu/parallel/dcn.py`) on the same inputs: the cases of
`tests/test_dcn.py`.  The cross-process sum itself runs in
`tests/test_torch_ddp.py` (two gloo processes)."""

import numpy as np
import pytest

from spr_pick_tpu.parallel import dcn as jdcn
from spr_pick_tpu.utils.metrics import MetricDict as JMetricDict
from spr_pick_tpu_torch.parallel import dcn
from spr_pick_tpu_torch.utils.metrics import MetricDict

KEYS = ["n", "psnr_out"]


@pytest.mark.parametrize("n_items,count", [(11, 4), (3, 5), (0, 2), (7, 1)])
def test_host_shard_partition_matches_jax(n_items, count):
    items = list(range(n_items))
    shards = [dcn.host_shard(items, i, count) for i in range(count)]
    assert shards == [jdcn.host_shard(items, i, count) for i in range(count)]
    assert sorted(x for s in shards for x in s) == items
    assert [len(s) for s in shards] == dcn.shard_sizes(n_items, count) \
        == jdcn.shard_sizes(n_items, count)


def test_host_shard_outside_a_group_is_the_identity():
    assert dcn.process_info() == (0, 1)
    assert dcn.host_shard(["a", "b", "c"]) == ["a", "b", "c"]
    assert dcn.allreduce_metrics(MetricDict(), KEYS) is None


def histories(fill):
    """The same accumulation into the port's and the JAX package's
    MetricDict."""
    out = []
    for cls in (MetricDict, JMetricDict):
        h = cls()
        fill(h)
        out.append(h)
    return out


def assert_same_metrics(port, jax_hist):
    for key in KEYS:
        a, b = port[key], jax_hist[key]
        if isinstance(b, (int, float)):
            assert type(a) is type(b) and a == b, key
        else:
            assert a.n == b.n, key
            if b.n:
                np.testing.assert_array_equal(a.accumulated(),
                                              b.accumulated())


def test_two_host_reduction_matches_jax_and_the_global_pass():
    """Each host accumulates its shard; the summed vectors give the global
    metrics, a host whose shard has no ground truth included."""
    psnrs = np.random.RandomState(0).rand(5) * 10 + 20

    def fill_host(host):
        def fill(h):
            for i in dcn.host_shard(list(range(5)), host, 2):
                h["n"] += 1
                if i < 3:
                    h["psnr_out"] += psnrs[i]
        return fill

    vecs, jvecs = [], []
    for host in range(2):
        port, jh = histories(fill_host(host))
        vecs.append(dcn.metrics_to_vector(port, KEYS))
        jvecs.append(jdcn.metrics_to_vector(jh, KEYS))
        np.testing.assert_array_equal(vecs[-1], jvecs[-1])
    out, jout = MetricDict(), JMetricDict()
    dcn.vector_to_metrics(out, KEYS, sum(vecs))
    jdcn.vector_to_metrics(jout, KEYS, sum(jvecs))
    assert_same_metrics(out, jout)
    assert out["n"].n == 5
    np.testing.assert_allclose(out["psnr_out"].accumulated(),
                               psnrs[:3].mean())


def test_plain_int_n_round_trip_matches_jax():
    def fill(count, host):
        def f(h):
            h["n"] = 0
            h["n"] += count
            h["psnr_out"] += 20.0 + host
        return f

    merged, jmerged = 0, 0
    for host, count in enumerate((3, 2)):
        port, jh = histories(fill(count, host))
        merged = merged + dcn.metrics_to_vector(port, KEYS)
        jmerged = jmerged + jdcn.metrics_to_vector(jh, KEYS)
    np.testing.assert_array_equal(merged, jmerged)
    out, jout = MetricDict(), JMetricDict()
    out["n"] = jout["n"] = 0
    dcn.vector_to_metrics(out, KEYS, merged)
    jdcn.vector_to_metrics(jout, KEYS, jmerged)
    assert isinstance(out["n"], int) and out["n"] == 5
    assert_same_metrics(out, jout)


def test_base_delta_counts_nothing_twice():
    """Two eval windows between resets over three hosts: the second merge
    exchanges only each host's delta since the first (the ``base`` rule)."""
    n_hosts = 3
    psnrs = np.random.RandomState(1).rand(2, n_hosts) * 10 + 20

    def merge(mod, hists, base):
        locals_ = [mod.metrics_to_vector(h, KEYS) for h in hists]
        if base is not None:
            locals_ = [v - base for v in locals_]
        merged = sum(locals_)
        if base is not None:
            merged = merged + base
        for h in hists:
            mod.vector_to_metrics(h, KEYS, merged)
        return merged

    results = []
    for mod, cls in ((dcn, MetricDict), (jdcn, JMetricDict)):
        hists = [cls() for _ in range(n_hosts)]
        base = None
        for window in range(2):
            for host, h in enumerate(hists):
                h["n"] = h["n"] + 1 if "n" in h else 1
                h["psnr_out"] += psnrs[window, host]
            base = merge(mod, hists, base)
        results.append(hists[0])
    port, jh = results
    assert port["n"] == 2 * n_hosts
    assert port["psnr_out"].n == 2 * n_hosts
    np.testing.assert_allclose(port["psnr_out"].accumulated(), psnrs.mean())
    assert_same_metrics(port, jh)


def test_empty_metrics_merge_as_zeros():
    port, jh = histories(lambda h: None)
    vec = dcn.metrics_to_vector(port, KEYS)
    np.testing.assert_array_equal(vec, jdcn.metrics_to_vector(jh, KEYS))
    assert not vec.any()
    out = MetricDict()
    out["psnr_out"] += 25.0
    dcn.vector_to_metrics(out, KEYS, vec)
    assert out["psnr_out"].empty() and out["n"].empty()
