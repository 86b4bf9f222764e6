"""The keyed metric table of the port (``torcheval_tpu_torch.table``) against
the JAX package's (``torcheval_tpu.table``), on the CPU: key hashes, every
family, shape bucketing, eviction, reprs, the counters and the memory
accounting. The same numpy rows go to both packages.

The data is dyadic (eighths) or integer-valued where the values are
compared bitwise, as the JAX package's own table tests make it; the NE
families go through ``log``, whose float32 implementations differ by an
ulp between XLA and torch, so their values and their cross-entropy columns
are compared at rtol 1e-6, their count columns bitwise. ``TableValues.keys`` (the slot order)
is compared exactly everywhere, including keys whose hash is at or above
2^63."""

from __future__ import annotations

import doctest
import importlib

import numpy as np
import pytest
import torch

from torcheval_tpu.metrics import ShardContext as JShard
from torcheval_tpu.metrics.toolkit import adopt_synced as j_adopt
from torcheval_tpu.table import MetricTable as JTable
from torcheval_tpu.table import hash_keys as j_hash_keys
from torcheval_tpu.table import owner_of as j_owner_of
from torcheval_tpu.table._hash import split_planes as j_split_planes
from torcheval_tpu_torch import config
from torcheval_tpu_torch.metrics import _fuse as tfuse
from torcheval_tpu_torch.metrics import ShardContext
from torcheval_tpu_torch.metrics.toolkit import adopt_synced
from torcheval_tpu_torch.obs.memory import memory_report
from torcheval_tpu_torch.table import FAMILIES, MetricTable, TableValues, hash_keys, owner_of
from torcheval_tpu_torch.table._hash import order_keys, split_planes
from torcheval_tpu_torch.utils.convert import load_numpy_state_dict, numpy_state_dict
from torcheval_tpu_torch.utils.test_utils import OverloadSchedule
from tests.test_torch_port_fuse import emulated_graphs  # noqa: F401  (fixture)

CPU = "cpu"
NE_RTOL = 1e-6  # log in XLA and torch differ by an ulp
# the NE families' cross-entropy columns hold logs: compared at NE_RTOL
NE_LOG_STATES = ("col_total_entropy", "ring_total_entropy")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def jax_sd(jt):
    """The JAX table's state_dict as numpy (tuples and scalars as they are)."""
    out = {}
    for k, v in jt.state_dict().items():
        out[k] = v if isinstance(v, (int, float, tuple)) else np.asarray(v)
    return out


def assert_same_state(pt, jt, rtol_states=()):
    assert_same_state_dicts(numpy_state_dict(pt), jax_sd(jt), rtol_states)


def assert_same_state_dicts(got, want, rtol_states=()):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, tuple):
            assert tuple(g) == w, k
        elif isinstance(w, (int, float)):
            assert g == w and type(g) is type(w), k
        else:
            g = _np(g)
            assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype, w.dtype, g.shape, w.shape)
            if k in rtol_states:
                np.testing.assert_allclose(g, w, rtol=NE_RTOL, atol=0, err_msg=k)
            else:
                assert g.tobytes() == w.tobytes(), k


def assert_same_values(tv_port, tv_jax, rtol=None):
    assert tv_port.keys.dtype == np.uint64
    np.testing.assert_array_equal(tv_port.keys, tv_jax.keys)
    got, want = _np(tv_port.values), np.asarray(tv_jax.values)
    if rtol is None:
        assert got.tobytes() == want.tobytes()
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0)
    assert tv_port.reprs == tv_jax.reprs


def _batches(seed, n_batches=6, rows=32, n_keys=24):
    rng = np.random.default_rng(seed)
    return [
        (
            rng.integers(0, n_keys, rows),
            rng.integers(0, 2, rows).astype(np.float32),
            (rng.integers(1, 8, rows) / 8).astype(np.float32),
        )
        for _ in range(n_batches)
    ]


def _family_args(family, c, w, rng):
    if family == "ctr":
        return (c, w)
    if family in ("weighted_calibration", "ne"):
        return (w, c, w) if family == "weighted_calibration" else ((w * 0.875).astype(np.float32), c, w)
    scores = (rng.integers(0, 8, (c.size, 6)) / 8).astype(np.float32)
    return (scores, rng.integers(0, 6, c.size))


# ------------------------------------------------------------------ hashing


def test_hash_values_equal_jax_for_every_key_kind():
    ints = np.array([0, 1, -1, 7, 2**40, -(2**62), 2**63 - 1], np.int64)
    big = np.array([2**63, 2**64 - 1, 12345678901234567890], np.uint64)
    strs = np.array(["user-1", "us_east", "", "ü"])
    objs = np.array([3, "x", b"y", 2**70], dtype=object)
    for keys in (ints, big, strs, objs, [5, 6], ["a", "b"], np.zeros((0,))):
        np.testing.assert_array_equal(hash_keys(keys), j_hash_keys(keys))
    h = hash_keys(np.arange(1000))
    for world in (1, 2, 3, 4, 7, 65536):
        np.testing.assert_array_equal(owner_of(h, world), j_owner_of(h, world))
    for a, b in zip(split_planes(h), j_split_planes(h)):
        np.testing.assert_array_equal(a, b)
    # an int key hashes alike in an int64 array and an object array
    assert hash_keys(np.array([3], dtype=object))[0] == hash_keys(np.array([3]))[0]
    with pytest.raises(TypeError):
        hash_keys(np.array([1.5]))


def test_order_keys_sort_like_unsigned_hashes():
    h = np.array([2**63, 1, 2**64 - 2, 2**63 - 1, 0, 2**62 + 5], np.uint64)
    assert np.array_equal(np.argsort(order_keys(h), kind="stable"), np.argsort(h, kind="stable"))
    # a plain signed view would put the high hashes first
    assert not np.array_equal(np.argsort(h.view(np.int64), kind="stable"), np.argsort(h, kind="stable"))


def _keys_around_2_63(n=40, seed=2):
    """Integer keys half of whose hashes lie at or above 2^63."""
    cand = np.arange(10_000)
    h = hash_keys(cand)
    high, low = cand[h >= np.uint64(2**63)], cand[h < np.uint64(2**63)]
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.choice(high, n // 2, replace=False), rng.choice(low, n // 2, replace=False)])


@pytest.mark.parametrize("world", [1, 3])
def test_keys_at_or_above_2_63_sort_and_own_as_in_jax(world):
    keys = _keys_around_2_63()
    assert (hash_keys(keys) >= np.uint64(2**63)).sum() == len(keys) // 2
    rng = np.random.default_rng(0)
    rows = rng.choice(keys, 200)
    clicks = rng.integers(0, 2, 200).astype(np.float32)
    for rank in range(world):
        pt = MetricTable("ctr", shard=ShardContext(rank, world), device=CPU)
        jt = JTable("ctr", shard=JShard(rank, world))
        pt.ingest(rows, clicks)
        jt.ingest(rows, clicks)
        tv = pt.compute()
        assert np.all(tv.keys[1:] > tv.keys[:-1])
        assert_same_values(tv, jt.compute())
        np.testing.assert_array_equal(owner_of(tv.keys, world), np.full(tv.keys.size, rank))
        assert_same_state(pt, jt)


# ----------------------------------------------------------------- families


@pytest.mark.parametrize("family", ["ctr", "weighted_calibration", "hit_rate", "ne"])
@pytest.mark.parametrize("bucketed", [False, True])
def test_family_values_and_states_equal_jax(family, bucketed):
    kwargs = {"k": 2} if family == "hit_rate" else {}
    pt, jt = MetricTable(family, device=CPU, **kwargs), JTable(family, **kwargs)
    rng_p, rng_j = np.random.default_rng(4), np.random.default_rng(4)
    for keys, c, w in _batches(3):
        args_p = _family_args(family, c, w, rng_p)
        args_j = _family_args(family, c, w, rng_j)
        if bucketed:
            pt.ingest(keys, *args_p)
        else:
            pt.update(keys, *args_p)
        jt.ingest(keys, *args_j)
    assert_same_values(pt.compute(), jt.compute(), rtol=NE_RTOL if family == "ne" else None)
    assert_same_state(pt, jt, NE_LOG_STATES)


def test_hit_rate_reads_out_of_range_targets_as_jax():
    scores = np.array([[0.5, 0.25, 0.125], [0.5, 0.5, 0.25], [0.125, 0.25, 0.5]], np.float32)
    targets = np.array([5, -1, 1])
    for k in (None, 1, 2, 3):
        pt, jt = MetricTable("hit_rate", k=k, device=CPU), JTable("hit_rate", k=k)
        pt.ingest([1, 2, 3], scores, targets)
        jt.ingest([1, 2, 3], scores, targets)
        assert_same_values(pt.compute(), jt.compute())


def test_windowed_ne_rings_commit_per_drain_epoch_as_jax():
    rng = np.random.default_rng(11)
    pt, jt = MetricTable("windowed_ne", window=3, device=CPU), JTable("windowed_ne", window=3)
    for _ in range(5):
        keys = rng.integers(0, 6, 20)
        preds = (rng.integers(1, 8, 20) / 8).astype(np.float32)
        targets = rng.integers(0, 2, 20).astype(np.float32)
        pt.ingest(keys, preds, targets)
        jt.ingest(keys, preds, targets)
        adopt_synced(pt)
        j_adopt(jt)
        assert_same_state(pt, jt, NE_LOG_STATES)
    assert_same_values(pt.compute(), jt.compute(), rtol=NE_RTOL)
    assert int(pt.epoch) == 5


def test_family_validation_matches_jax():
    with pytest.raises(ValueError, match="unknown table family"):
        MetricTable("nope", device=CPU)
    with pytest.raises(TypeError, match="unexpected"):
        MetricTable("ctr", k=3, device=CPU)
    with pytest.raises(ValueError, match="k should be"):
        MetricTable("hit_rate", k=0, device=CPU)
    with pytest.raises(ValueError, match="window"):
        MetricTable("windowed_ne", window=0, device=CPU)
    t = MetricTable("weighted_calibration", device=CPU)
    with pytest.raises(ValueError, match="different"):
        t.ingest([1, 2], [0.5, 0.5], [1.0])
    with pytest.raises(ValueError, match="one-dimensional"):
        t.ingest([1], [[0.5]], [[1.0]])
    with pytest.raises(ValueError, match="rows"):
        t.ingest([1, 2, 3], [0.5, 0.5], [1.0, 0.0])
    assert set(FAMILIES) >= {"ctr", "weighted_calibration", "hit_rate", "ne", "windowed_ne"}


# ------------------------------------------------------------ bucketing


def test_bucketed_ingest_bitwise_equal_to_unbucketed_with_the_same_outbox():
    rng = np.random.default_rng(7)
    batches = [
        (rng.integers(0, 30, n), rng.integers(0, 2, n).astype(np.float32),
         (rng.integers(1, 8, n) / 8).astype(np.float32))
        for n in (7, 13, 29, 5)
    ]
    plain = MetricTable("ctr", shard=ShardContext(0, 2), device=CPU)
    bucketed = MetricTable("ctr", shard=ShardContext(0, 2), device=CPU)
    jt = JTable("ctr", shard=JShard(0, 2))
    for b in batches:
        plain.update(*b)
        bucketed.ingest(*b)
        jt.ingest(*b)
    assert_same_values(bucketed.compute(), plain.compute())
    assert int(bucketed.out_h) == int(plain.out_h) == int(bucketed.out_n)
    assert_same_state(bucketed, jt)
    assert_same_state(plain, jt)


def test_outbox_holds_only_foreign_traffic_and_a_sentinel_scratch_entry():
    t = MetricTable("ctr", shard=ShardContext(0, 2), device=CPU)
    keys = np.arange(64)
    t.ingest(keys, np.ones(64, np.float32))
    foreign = int((owner_of(hash_keys(keys), 2) != 0).sum())
    assert int(t.out_h) == foreign == int(t.out_n)
    # every entry past the live ones is the sentinel
    assert bool(torch.all(t.out_hi[foreign:] == -1)) and bool(torch.all(t.out_val[foreign:] == 0))


def test_warmed_table_captures_no_graph_on_fresh_ragged_batches(emulated_graphs):
    rng = np.random.default_rng(5)
    keyspace = rng.integers(0, 1000, 2000)

    def feed(t, n):
        keys = keyspace[rng.integers(0, keyspace.size, n)]
        t.ingest(keys, rng.integers(0, 2, n).astype(np.float32), (rng.integers(1, 8, n) / 8).astype(np.float32))

    t = MetricTable("ctr", shard=ShardContext(1, 4), device=CPU)
    big = np.concatenate([keyspace, keyspace])
    t.ingest(big, np.zeros(big.size, np.float32), np.ones(big.size, np.float32))
    for n in (8, 16, 32, 64):
        feed(t, n)
    before = tfuse.graph_stats()["captures"]
    for n in (6, 10, 18, 34, 57):
        feed(t, n)
    assert tfuse.graph_stats()["captures"] == before
    assert tfuse.graph_stats()["replays"] > 0


def test_graphed_table_equals_eager_table(emulated_graphs):
    rng = np.random.default_rng(9)
    batches = [
        (rng.integers(0, 300, n), rng.integers(0, 2, n).astype(np.float32),
         (rng.integers(1, 8, n) / 8).astype(np.float32))
        for n in (64, 40, 3, 64, 17, 33, 64)
    ]
    graphed = MetricTable("ctr", shard=ShardContext(0, 2), device=CPU)
    for b in batches:
        graphed.ingest(*b)
    assert tfuse.graph_stats()["captures"] > 0
    with config.update_donation(False):
        eager = MetricTable("ctr", shard=ShardContext(0, 2), device=CPU)
        for b in batches:
            eager.ingest(*b)
    assert_same_values(graphed.compute(), eager.compute())
    a, b = numpy_state_dict(graphed), numpy_state_dict(eager)
    for k in a:
        assert np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes(), k


def test_ingest_captures_stay_bounded_under_overload_churn(emulated_graphs):
    sched = OverloadSchedule.ramp(20, 3.0, base_rows=48, base_keys=200, seed=11)
    sizes = {sched.rows_at(s) for s in range(len(sched))}
    buckets = {max(8, 1 << (int(n) - 1).bit_length()) for n in sizes}
    t = MetricTable("ctr", device=CPU)
    t.ingest(np.arange(200), np.ones(200, np.float32))
    start = tfuse.graph_stats()["captures"]
    for batch in sched.batches():
        t.ingest(batch.keys, **batch.kwargs)
    assert tfuse.graph_stats()["captures"] - start <= 2 * len(buckets) < len(sizes) + len(buckets)
    before = tfuse.graph_stats()["captures"]
    for batch in OverloadSchedule.ramp(20, 3.0, base_rows=48, base_keys=200, seed=12).batches():
        t.ingest(batch.keys, **batch.kwargs)
    assert tfuse.graph_stats()["captures"] == before


def test_empty_batch_is_a_host_noop_after_validation():
    t = MetricTable("ctr", device=CPU)
    t.ingest([], np.zeros(0, np.float32))
    assert int(t.n_keys) == 0
    with pytest.raises(ValueError):
        t.ingest([], np.zeros((0, 2), np.float32))


# ------------------------------------------------------------------ eviction


@pytest.mark.parametrize("kwargs", [{"ttl": 2}, {"max_keys": 5}, {"ttl": 1, "max_keys": 3}])
def test_eviction_equals_jax(kwargs):
    rng = np.random.default_rng(21)
    pt, jt = MetricTable("ctr", device=CPU, **kwargs), JTable("ctr", **kwargs)
    for epoch in range(5):
        keys = _keys_around_2_63(8, seed=epoch)[rng.integers(0, 8, 6)]
        c = rng.integers(0, 2, 6).astype(np.float32)
        pt.ingest(keys, c)
        jt.ingest(keys, c)
        adopt_synced(pt)
        j_adopt(jt)
        assert_same_state(pt, jt)
        assert int(pt.evictions_total) == int(jt.evictions_total)
    assert_same_values(pt.compute(), jt.compute())


def test_max_keys_evicts_oldest_first_ties_by_ascending_hash():
    t = MetricTable("ctr", max_keys=4, device=CPU)
    keys = _keys_around_2_63(8)
    t.ingest(keys, np.ones(8, np.float32))
    adopt_synced(t)
    # every key was seen at epoch 0: the tie breaks by ascending uint64 hash
    kept = np.sort(hash_keys(keys))[-4:]
    np.testing.assert_array_equal(t.compute().keys, kept)
    assert int(t.evictions_total) == 4


# ---------------------------------------------------- reprs, counters, memory


def test_string_keys_reprs_and_scrape_equal_jax():
    keys = ["us-east", "us_east", "eu", "eu", 7]
    pt, jt = MetricTable("ctr", device=CPU), JTable("ctr")
    c = np.array([1, 0, 1, 1, 0], np.float32)
    pt.ingest(np.array(keys, dtype=object), c)
    jt.ingest(np.array(keys, dtype=object), c)
    assert pt.scrape_values() == jt.scrape_values()
    assert pt.compute().as_dict() == jt.compute().as_dict()
    small = MetricTable("ctr", repr_limit=2, device=CPU)
    small.ingest(np.arange(10), np.ones(10, np.float32))
    assert len(small._reprs) == 2


def test_counter_source_and_prometheus_scrape():
    from torcheval_tpu_torch import obs
    from torcheval_tpu_torch.obs.counters import CounterRegistry

    pt, jt = MetricTable("ctr", shard=ShardContext(0, 2), device=CPU), JTable("ctr", shard=JShard(0, 2))
    keys, c, w = _batches(8)[0]
    pt.ingest(keys, c, w)
    jt.ingest(keys, c, w)
    got, want = pt.counter_source(), jt.counter_source()
    assert set(got) == set(want)
    for k in ("occupancy", "global_keys", "capacity", "epoch", "inserts_total", "outbox_entries",
              "admission_rung", "sampled_fraction", "logical_bytes"):
        assert got[k] == want[k], k
    reg = CounterRegistry()
    pt.track(registry=reg)
    pt.track_values(registry=reg, limit=3)
    snap = reg.read()
    assert snap["metric_table"]["occupancy"] == int(pt.n_keys)
    assert snap["metric_table_values"]["shed_fraction"] == 0.0
    assert "metric_table_values" in obs.render_prometheus(registry=reg)


def test_memory_report_logical_against_per_rank():
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 4000, 8000)
    ones = np.ones(keys.size, np.float32)
    single = MetricTable("ctr", device=CPU)
    single.ingest(keys, ones)
    rep1 = memory_report({"t": single})["t"]
    assert rep1["logical_bytes"] == rep1["per_rank_bytes"] and not rep1["sharded"]
    ranks = [MetricTable("ctr", shard=ShardContext(r, 4), device=CPU) for r in range(4)]
    for t in ranks:
        t.ingest(keys, ones)
    from torcheval_tpu_torch.utils.test_utils import ThreadWorld

    ThreadWorld(4).run(lambda g: adopt_synced(ranks[g.rank], g))
    for t in ranks:
        rep = memory_report({"t": t})["t"]
        assert rep["sharded"]
        assert rep["logical_bytes"] / 8 <= rep["per_rank_bytes"] <= 2 * rep["logical_bytes"] / 4


# -------------------------------------------------------- lifecycle, loads


def test_state_dicts_cross_load_both_ways_mid_stream():
    batches = _batches(13)
    pt, jt = MetricTable("ctr", shard=ShardContext(1, 3), device=CPU), JTable("ctr", shard=JShard(1, 3))
    for b in batches[:3]:
        jt.ingest(*b)
    load_numpy_state_dict(pt, jax_sd(jt))
    assert_same_state(pt, jt)
    for b in batches[3:]:
        pt.ingest(*b)
        jt.ingest(*b)
    assert_same_state(pt, jt)
    back = JTable("ctr", shard=JShard(1, 3))
    back.load_state_dict(numpy_state_dict(pt))
    assert_same_state(pt, back)
    assert_same_values(pt.compute(), back.compute())


def test_merged_table_rejects_ingest_and_reslices_on_load():
    ranks = [MetricTable("ctr", shard=ShardContext(r, 2), device=CPU) for r in range(2)]
    keys, c, w = _batches(2)[0]
    for t in ranks:
        t.ingest(keys, c, w)
    merged = ranks[0]
    import copy

    merged = copy.deepcopy(ranks[0]).merge_state([copy.deepcopy(ranks[1])])
    assert int(merged._owner_rank) == -1
    with pytest.raises(RuntimeError, match="logical"):
        merged.ingest(keys, c, w)
    fresh = MetricTable("ctr", shard=ShardContext(1, 2), device=CPU)
    fresh.load_state_dict(merged.state_dict())
    assert int(fresh._owner_rank) == 1
    np.testing.assert_array_equal(owner_of(fresh.compute().keys, 2), 1)
    foreign = MetricTable("ctr", shard=ShardContext(0, 2), device=CPU)
    foreign.load_state_dict(ranks[1].state_dict())
    with pytest.raises(RuntimeError, match="foreign carriers"):
        foreign.ingest(keys, c, w)


def test_strict_load_reset_and_constructor_validation():
    t = MetricTable("ctr", device=CPU)
    t.ingest([1, 2], [1.0, 0.0])
    sd = t.state_dict()
    del sd["epoch"]
    with pytest.raises(RuntimeError, match="missing keys"):
        t.load_state_dict(sd)
    t.reset()
    assert int(t.n_keys) == 0 and t.compute().keys.size == 0 and t._slot_key.numel() == 0
    t.ingest([3], [1.0])
    assert t.compute().as_dict() == {3: 1.0}
    with pytest.raises(ValueError, match="ttl"):
        MetricTable("ctr", ttl=0, device=CPU)
    with pytest.raises(ValueError, match="max_keys"):
        MetricTable("ctr", max_keys=0, device=CPU)
    with pytest.raises(ValueError, match="staleness"):
        MetricTable("ctr", staleness_epochs=-1, device=CPU)
    assert isinstance(t.compute(), TableValues)


def test_staleness_budget_registry_and_config_knob():
    from torcheval_tpu_torch.table import tightest_staleness_budget

    import gc

    base = tightest_staleness_budget()  # 0 unless another live table declared one
    a = MetricTable("ctr", staleness_epochs=5, device=CPU)
    b = MetricTable("ctr", staleness_epochs=3, device=CPU)
    assert tightest_staleness_budget() == (min(base, 3) if base else 3)
    del b
    gc.collect()  # weakly held: a collected tenant stops constraining
    assert tightest_staleness_budget() == (min(base, 5) if base else 5)
    assert a.staleness_epochs == 5
    prev = config.tenant_staleness_epochs()
    try:
        config.set_tenant_staleness_epochs(4)
        assert MetricTable("ctr", device=CPU).staleness_epochs == 4
        with pytest.raises(ValueError):
            config.set_tenant_staleness_epochs(-1)
    finally:
        config.set_tenant_staleness_epochs(prev)


def test_table_doctests_run():
    for module in ("table", "panel", "streaming"):
        result = doctest.testmod(importlib.import_module(f"torcheval_tpu_torch.table.{module}"))
        assert result.failed == 0 and result.attempted > 0, module
