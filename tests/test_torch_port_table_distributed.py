"""The keyed metric table across ranks, on the CPU: ``ThreadWorld`` syncs and
adopts of the port against the JAX package's (same rows, same ranks, the
same merge order, so bitwise on dyadic data), the drain's per-rank bytes
and payloads, an elastic snapshot at world 4 restored at world 2 (keys
re-hashed to ``hash % 2``), and the repr gather."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torcheval_tpu.metrics import ShardContext as JShard
from torcheval_tpu.metrics import toolkit as jtoolkit
from torcheval_tpu.table import MetricTable as JTable
from torcheval_tpu.utils.test_utils import ThreadWorld as JThreadWorld
from torcheval_tpu_torch.elastic import ElasticSession
from torcheval_tpu_torch.metrics import ShardContext, toolkit
from torcheval_tpu_torch.metrics.synclib import _pack_rank_states, metrics_traversal_order
from torcheval_tpu_torch.table import MetricTable, TablePanel, owner_of
from torcheval_tpu_torch.utils.test_utils import ThreadWorld
from tests.test_torch_port_table import assert_same_state, assert_same_values

CPU = "cpu"
WORLD = 4


def _rank_batches(seed, rows=48, n_batches=5, n_keys=60):
    """Per-rank streams of dyadic CTR rows (clicks, eighths of weight)."""
    rng = np.random.default_rng(seed)
    return [
        [
            (rng.integers(0, n_keys, rows), rng.integers(0, 2, rows).astype(np.float32),
             (rng.integers(1, 8, rows) / 8).astype(np.float32))
            for _ in range(n_batches)
        ]
        for _ in range(WORLD)
    ]


def _port_world(streams, family="ctr", **kw):
    tables = [MetricTable(family, shard=ShardContext(r, WORLD), device=CPU, **kw) for r in range(WORLD)]
    for t, stream in zip(tables, streams):
        for b in stream:
            t.ingest(*b)
    return tables


def _jax_world(streams, family="ctr", **kw):
    tables = [JTable(family, shard=JShard(r, WORLD), **kw) for r in range(WORLD)]
    for t, stream in zip(tables, streams):
        for b in stream:
            t.ingest(*b)
    return tables


def test_thread_world_sync_equals_jax_and_the_world1_replay():
    streams = _rank_batches(1)
    pts, jts = _port_world(streams), _jax_world(streams)
    got = ThreadWorld(WORLD).run(lambda g: toolkit.get_synced_metric(pts[g.rank], g))
    want = JThreadWorld(WORLD).run(lambda g: jtoolkit.get_synced_metric(jts[g.rank], g))
    one = MetricTable("ctr", device=CPU)
    for stream in streams:
        for b in stream:
            one.ingest(*b)
    for g, w in zip(got, want):
        assert int(g._owner_rank) == -1
        assert_same_values(g.compute(), w.compute())
        assert_same_state(g, w)
        # dyadic rows: the rank-ordered fold equals the single stream
        np.testing.assert_array_equal(g.compute().keys, one.compute().keys)
        assert torch.equal(g.compute().values, one.compute().values)
    assert got[0].sync_provenance.ranks == (0, 1, 2, 3)


def test_adopt_drains_to_owned_keys_equal_to_jax_and_keeps_syncing_exactly():
    streams, more = _rank_batches(2), _rank_batches(3)
    pts, jts = _port_world(streams), _jax_world(streams)
    ThreadWorld(WORLD).run(lambda g: toolkit.adopt_synced(pts[g.rank], g))
    JThreadWorld(WORLD).run(lambda g: jtoolkit.adopt_synced(jts[g.rank], g))
    for r, (p, j) in enumerate(zip(pts, jts)):
        assert int(p.out_h) == 0 and int(p._owner_rank) == r and int(p.epoch) == 1
        np.testing.assert_array_equal(owner_of(p.compute().keys, WORLD), r)
        assert_same_state(p, j)
    for p, j, stream in zip(pts, jts, more):
        for b in stream:
            p.ingest(*b)
            j.ingest(*b)
    got = ThreadWorld(WORLD).run(lambda g: toolkit.sync_and_compute(pts[g.rank], g))
    want = JThreadWorld(WORLD).run(lambda g: jtoolkit.sync_and_compute(jts[g.rank], g))
    for g, w in zip(got, want):
        assert_same_values(g, w)


def test_adopt_bytes_and_payload_below_the_world1_table():
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 5000, 4 * 4096)
    ones = np.ones(keys.size, np.float32)
    quarters = np.array_split(np.arange(keys.size), WORLD)
    pts = [MetricTable("ctr", shard=ShardContext(r, WORLD), device=CPU) for r in range(WORLD)]
    for t, q in zip(pts, quarters):
        t.ingest(keys[q], ones[q])
    one = MetricTable("ctr", device=CPU)
    one.ingest(keys, ones)

    def payload(m):
        states = {"t": m._sync_state_dict()}
        return _pack_rank_states(states, metrics_traversal_order(states))[1].nbytes

    before = [payload(t) for t in pts]
    ThreadWorld(WORLD).run(lambda g: toolkit.adopt_synced(pts[g.rank], g))
    from torcheval_tpu_torch.obs.memory import memory_report

    for t in pts:
        rep = memory_report({"t": t})["t"]
        assert rep["logical_bytes"] / (2 * WORLD) <= rep["per_rank_bytes"] <= 2 * rep["logical_bytes"] / WORLD
        assert payload(t) < payload(one)
    assert max(before) < 2 * payload(one)


def test_panel_sync_over_ranks_equals_jax():
    from torcheval_tpu.table import TablePanel as JPanel

    streams = _rank_batches(6, n_batches=3)
    members = ["ctr", ("cal", "weighted_calibration"), ("wne", "windowed_ne", {"window": 2})]
    pts = [TablePanel(members, shard=ShardContext(r, WORLD), device=CPU) for r in range(WORLD)]
    jts = [JPanel(members, shard=JShard(r, WORLD)) for r in range(WORLD)]
    for p, j, stream in zip(pts, jts, streams):
        for k, c, w in stream:
            bundle = dict(ctr=(c, w), cal=(w, c, w), wne=(w * 0.5, c, w))
            p.ingest(k, **bundle)
            j.ingest(k, **bundle)
    ThreadWorld(WORLD).run(lambda g: toolkit.adopt_synced(pts[g.rank], g))
    JThreadWorld(WORLD).run(lambda g: jtoolkit.adopt_synced(jts[g.rank], g))
    for p, j in zip(pts, jts):
        assert_same_state(p, j, ("col_wne__total_entropy", "ring_wne__total_entropy"))


@pytest.mark.parametrize("new_world", [2])
def test_elastic_restore_rehashes_keys_at_a_world_change(tmp_path, new_world):
    streams = _rank_batches(7, n_batches=3)
    pts = _port_world(streams)
    merged = ThreadWorld(WORLD).run(lambda g: toolkit.get_synced_metric(pts[g.rank], g))[0]

    def snap(g):
        session = ElasticSession({"t": pts[g.rank]}, str(tmp_path), process_group=g, interval=1)
        session.snapshot()

    ThreadWorld(WORLD).run(snap)
    fresh = [MetricTable("ctr", shard=ShardContext(r, new_world), device=CPU) for r in range(new_world)]

    def restore(g):
        session = ElasticSession({"t": fresh[g.rank]}, str(tmp_path), process_group=g, interval=1)
        return session.restore()

    results = ThreadWorld(new_world).run(restore)
    assert all(r is not None and r.world_size == WORLD for r in results)
    for r, t in enumerate(fresh):
        assert int(t._owner_rank) == r and int(t._owner_world) == new_world and int(t.out_h) == 0
        np.testing.assert_array_equal(owner_of(t.compute().keys, new_world), r)
    again = ThreadWorld(new_world).run(lambda g: toolkit.get_synced_metric(fresh[g.rank], g))[0]
    assert_same_values(again.compute(), merged.compute())


def test_gather_key_reprs_resolves_every_rank_key():
    streams = _rank_batches(8, n_batches=1)
    pts = _port_world(streams)
    out = ThreadWorld(WORLD).run(lambda g: pts[g.rank].gather_key_reprs(g))
    keys = np.unique(np.concatenate([s[0][0] for s in streams]))
    assert sorted(out[0].values()) == sorted(int(k) for k in keys)
    assert all(o == out[0] for o in out)
    assert len(pts[3]._reprs) == len(out[0])
