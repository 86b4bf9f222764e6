"""``StreamTable`` of the port against the port's standalone streaming
metrics (bitwise: one row a request a step, so the keyed fold is the
standalone chain) and against the JAX package's ``StreamTable`` (states
bitwise; the per-key perplexity and n-gram overlap go through exp/log,
compared at rtol 1e-6), on the CPU: ragged decode steps, finish and drain
into the sketches, world-4 adopts under per-request rank affinity, a
mid-stream state round trip, an elastic 2->4 restore, admission shedding
that never drops finals, and zero new graph captures on a warmed table."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torcheval_tpu.table import StreamTable as JStreamTable
from torcheval_tpu_torch.elastic import ElasticSession
from torcheval_tpu_torch.metrics import ShardContext
from torcheval_tpu_torch.metrics import _fuse as tfuse
from torcheval_tpu_torch.metrics.toolkit import adopt_synced
from torcheval_tpu_torch.streaming import (
    StreamingNgramOverlap,
    StreamingPerplexity,
    StreamingTokenAccuracy,
    StreamingTokenEditStats,
)
from torcheval_tpu_torch.table import (
    AdmissionController,
    MetricTable,
    ServingBudget,
    StreamTable,
    stream_logprob_family,
)
from torcheval_tpu_torch.utils.convert import load_numpy_state_dict, numpy_state_dict
from torcheval_tpu_torch.utils.test_utils import ThreadWorld
from tests.test_torch_port_fuse import emulated_graphs  # noqa: F401  (fixture)
from tests.test_torch_port_table import NE_RTOL as VALUE_RTOL
from tests.test_torch_port_table import assert_same_state_dicts, jax_sd

CPU = "cpu"
ALL = ("logprob", "token_edit", "token_accuracy", "ngram")


def _streams(n_requests=6, seed=3, max_len=14):
    rng = np.random.default_rng(seed)
    out = {}
    for rid in range(n_requests):
        n = int(rng.integers(4, max_len))
        hyp = rng.integers(0, 25, n).astype(np.int32)
        ref = np.where(rng.uniform(size=n) < 0.6, hyp, rng.integers(0, 25, n)).astype(np.int32)
        lp = (-rng.uniform(0.05, 3.0, n)).astype(np.float32)
        out[rid] = (lp, hyp, ref)
    return out


def _drive(table, streams, steps=None):
    horizon = max(len(lp) for lp, _, _ in streams.values())
    for s in range(horizon) if steps is None else steps:
        ids = [r for r, (lp, _, _) in streams.items() if s < len(lp)]
        table.ingest(
            np.asarray(ids, np.int64),
            step_tokens=np.asarray([streams[r][1][s] for r in ids], np.int32),
            logprobs=np.asarray([streams[r][0][s] for r in ids], np.float32),
            ref_tokens=np.asarray([streams[r][2][s] for r in ids], np.int32),
        )
    return table


def _standalone(lp, hyp, ref, n_gram=3):
    ppl, edit = StreamingPerplexity(device=CPU), StreamingTokenEditStats(device=CPU)
    acc, ngram = StreamingTokenAccuracy(device=CPU), StreamingNgramOverlap(n_gram=n_gram, device=CPU)
    for s in range(len(lp)):
        ppl.update(lp[s : s + 1])
        edit.update(hyp[s : s + 1], ref[s : s + 1])
        acc.update(hyp[s : s + 1], ref[s : s + 1])
        ngram.update(hyp[s : s + 1], ref[s : s + 1])
    ngram.finish()
    return {
        "logprob": float(ppl.compute()),
        "token_edit": float(edit.compute().error_rate),
        "token_accuracy": float(acc.compute()),
        "ngram": float(ngram.compute().overlap),
    }


def _same_extras(a, b):
    """``stream_extras`` alike but for the span clocks (wall time)."""
    fa, sa, ba, pa, ta = a
    fb, sb, bb, pb, tb = b
    assert tuple(fa) == tuple(fb) and ta == tb
    assert len(sa) == len(sb)
    for x, y in zip(sa, sb):
        assert x[:2] == y[:2] and x[3:7] == y[3:7]
        for u, v in zip(x[7:], y[7:]):
            assert (u is None and v is None) or np.array_equal(u, v)
    for (k1, v1), (k2, v2) in zip(list(ba) + list(pa), list(bb) + list(pb)):
        assert k1 == k2
        if k1 != "latency":
            np.testing.assert_array_equal(v1, v2)


def _assert_same_stream_state(pt, jt):
    got, want = numpy_state_dict(pt), jax_sd(jt)
    _same_extras(got.pop("stream_extras"), want.pop("stream_extras"))
    assert_same_state_dicts(got, want)


def test_keyed_values_match_standalone_metrics_bitwise_and_jax():
    streams = _streams()
    pt = _drive(StreamTable(members=ALL, n_gram=3, device=CPU), streams)
    jt = _drive(JStreamTable(members=ALL, n_gram=3), streams)
    pt.finish(np.asarray(sorted(streams)))
    jt.finish(np.asarray(sorted(streams)))
    got = pt.compute().as_dict()
    for rid, (lp, hyp, ref) in streams.items():
        want = _standalone(lp, hyp, ref)
        for member in ALL:
            assert got[member][rid] == want[member], (member, rid)
    jgot = jt.compute()
    np.testing.assert_array_equal(pt.compute().keys, jgot.keys)
    for member in ALL:
        np.testing.assert_allclose(pt.compute().values[member].numpy(), np.asarray(jgot.values[member]),
                                   rtol=VALUE_RTOL, atol=0)
    _assert_same_stream_state(pt, jt)


def test_single_family_table_equals_the_panel_member():
    streams = _streams(seed=4)
    single = MetricTable(stream_logprob_family(), device=CPU)
    for s in range(14):
        ids = [r for r, (lp, _, _) in streams.items() if s < len(lp)]
        if ids:
            single.ingest(np.asarray(ids), np.asarray([streams[r][0][s] for r in ids], np.float32))
    panel = _drive(StreamTable(members=("logprob",), device=CPU), streams)
    a, b = single.compute(), panel.compute()
    assert torch.equal(a.values, b.values["logprob"])


def test_warmed_stream_table_captures_nothing_on_ragged_active_sets(emulated_graphs):
    rng = np.random.default_rng(0)
    t = StreamTable(members=("logprob", "token_edit"), shard=ShardContext(0, 1), device=CPU)
    ids = np.arange(64)

    def step(n):
        rows = rng.choice(ids, n, replace=False)
        t.ingest(rows, step_tokens=rng.integers(0, 50, n).astype(np.int32),
                 logprobs=(-rng.uniform(0.1, 2, n)).astype(np.float32),
                 ref_tokens=rng.integers(0, 50, n).astype(np.int32))

    for n in (64, 8, 16, 32):
        step(n)
    before = tfuse.graph_stats()["captures"]
    for n in (5, 11, 23, 47, 64, 1):
        step(n)
    t.ingest(np.zeros(0, np.int64), step_tokens=np.zeros(0, np.int32),
             logprobs=np.zeros(0, np.float32), ref_tokens=np.zeros(0, np.int32))
    assert tfuse.graph_stats()["captures"] == before


def test_finish_and_drain_retire_requests_into_the_sketches_as_jax():
    streams = _streams(n_requests=5)
    pt = _drive(StreamTable(members=("logprob", "token_edit"), device=CPU), streams)
    jt = _drive(JStreamTable(members=("logprob", "token_edit")), streams)
    assert pt.active_requests == 5
    for t in (pt, jt):
        t.finish([0, 1, 2])
    assert pt.active_requests == 2 and int(pt.n_keys) == 5
    pt._pre_adopt_commit()
    jt._pre_adopt_commit()
    assert int(pt.n_keys) == 2 and pt.counter_source()["finished_requests_total"] == 3
    ps, js = pt.finished_summary(), jt.finished_summary()
    assert ps.keys() == js.keys()
    for k in ps:
        np.testing.assert_array_equal(ps[k]["edges"], js[k]["edges"])
        if k != "latency":
            np.testing.assert_array_equal(ps[k]["counts"], js[k]["counts"])
    pt.finish([0, 1, 2])
    pt._pre_adopt_commit()
    assert pt.counter_source()["finished_requests_total"] == 3


def _affinity_batches():
    out = []
    for i in range(8):
        rng = np.random.default_rng(100 + i)
        ids = rng.integers(0, 15, 32) * 4 + (i % 4)
        ids = np.unique(ids)  # one row a request a step
        n = ids.size
        out.append((ids, rng.integers(0, 50, n).astype(np.int32),
                    (-rng.uniform(0.1, 2.0, n)).astype(np.float32), rng.integers(0, 50, n).astype(np.int32)))
    return out


def test_world4_adopt_equals_world1_under_request_affinity():
    batches = _affinity_batches()
    fin = {r: np.unique(batches[r][0])[:5] for r in range(4)}
    w1 = StreamTable(members=("logprob", "token_edit"), device=CPU)
    for r in range(4):
        for i in range(r, len(batches), 4):
            k, s, lp, rr = batches[i]
            w1.ingest(k, step_tokens=s, logprobs=lp, ref_tokens=rr)
        w1.finish(fin[r])
    w1._pre_adopt_commit()
    want = w1.compute().as_dict()
    tables = [StreamTable(members=("logprob", "token_edit"), shard=ShardContext(r, 4), device=CPU)
              for r in range(4)]

    def body(g):
        t = tables[g.rank]
        for i in range(g.rank, len(batches), 4):
            k, s, lp, r = batches[i]
            t.ingest(k, step_tokens=s, logprobs=lp, ref_tokens=r)
        t.finish(fin[g.rank])
        merged = adopt_synced(t, g)
        return merged.compute().as_dict(), {k: v["counts"].tolist()
                                            for k, v in merged.finished_summary().items() if k != "latency"}

    results = ThreadWorld(4).run(body)
    assert all(r == results[0] for r in results)
    assert results[0][0] == want
    assert results[0][1] == {k: v["counts"].tolist() for k, v in w1.finished_summary().items()
                             if k != "latency"}


def test_mid_stream_state_cross_loads_both_ways_then_finishes_alike():
    streams = _streams(seed=5)
    jt = _drive(JStreamTable(members=("logprob", "ngram"), n_gram=3), streams, steps=range(5))
    pt = StreamTable(members=("logprob", "ngram"), n_gram=3, device=CPU)
    load_numpy_state_dict(pt, jax_sd(jt))
    _drive(pt, streams, steps=range(5, 14))
    _drive(jt, streams, steps=range(5, 14))
    back = JStreamTable(members=("logprob", "ngram"), n_gram=3)
    back.load_state_dict(numpy_state_dict(pt))
    for t in (pt, jt, back):
        t.finish(np.asarray(sorted(streams)))
    _assert_same_stream_state(pt, jt)
    _assert_same_stream_state(pt, back)
    got = pt.compute().as_dict()["ngram"]
    for rid, (lp, hyp, ref) in streams.items():
        assert got[rid] == _standalone(lp, hyp, ref)["ngram"], rid


def test_elastic_restore_2_to_4_mid_stream_bitwise(tmp_path):
    streams = _streams(n_requests=8, seed=6)
    members = ("logprob", "token_edit", "ngram")
    old = [StreamTable(members=members, n_gram=3, shard=ShardContext(r, 2), device=CPU) for r in range(2)]

    def feed(tables, world, steps):
        for s in steps:
            for r, t in enumerate(tables):
                ids = [q for q, (lp, _, _) in streams.items() if s < len(lp) and q % world == r]
                if ids:
                    t.ingest(np.asarray(ids), step_tokens=np.asarray([streams[q][1][s] for q in ids], np.int32),
                             logprobs=np.asarray([streams[q][0][s] for q in ids], np.float32),
                             ref_tokens=np.asarray([streams[q][2][s] for q in ids], np.int32))

    feed(old, 2, range(6))

    def snap(g):
        ElasticSession({"t": old[g.rank]}, str(tmp_path), process_group=g, interval=1).snapshot()

    ThreadWorld(2).run(snap)
    new = [StreamTable(members=members, n_gram=3, shard=ShardContext(r, 4), device=CPU) for r in range(4)]
    ThreadWorld(4).run(lambda g: ElasticSession({"t": new[g.rank]}, str(tmp_path), process_group=g,
                                                interval=1).restore())
    feed(new, 4, range(6, 14))
    for t in new:
        t.finish(np.asarray(sorted(streams)))
    merged = ThreadWorld(4).run(lambda g: adopt_synced(new[g.rank], g))[0]
    got = merged.compute().as_dict()
    for rid, (lp, hyp, ref) in streams.items():
        want = _standalone(lp, hyp, ref)
        for m in members:
            assert got[m].get(rid, want[m]) == want[m], (m, rid)


def test_admission_sheds_decode_rows_but_never_finals():
    streams = _streams(n_requests=40, seed=7)
    t = StreamTable(members=("logprob", "ngram"), n_gram=2, device=CPU,
                    admission=AdmissionController(ServingBudget(max_keys=10**6), sample_p=0.5))
    try:
        t.admission_rung = 1
        _drive(t, streams)
        t.finish(np.asarray(sorted(streams)))
        assert int(t.shed_rows_total) > 0
        finished = t.compute().values["ngram"]
        fin_col = t.col_ngram__finished[: int(t.n_keys)]
        assert int(fin_col.sum()) == len(streams)  # every final landed
        assert finished.shape[0] == len(streams)
    finally:
        t.disarm_admission()


def test_member_validation_and_required_kwargs():
    with pytest.raises(ValueError, match="at least one"):
        StreamTable(members=(), device=CPU)
    with pytest.raises(ValueError, match="unknown"):
        StreamTable(members=("bleu",), device=CPU)
    with pytest.raises(ValueError, match="duplicate"):
        StreamTable(members=("logprob", "logprob"), device=CPU)
    with pytest.raises(ValueError, match="power of two"):
        StreamTable(members=("ngram",), ngram_buckets=12, device=CPU)
    t = StreamTable(members=("logprob", "token_edit"), device=CPU)
    with pytest.raises(ValueError, match="logprobs="):
        t.ingest([1], step_tokens=[1])
    with pytest.raises(ValueError, match="step_tokens="):
        t.ingest([1], logprobs=[-0.5])
    # as in the JAX package, the mirror observes the step before the
    # member arguments are checked
    jt = JStreamTable(members=("logprob", "token_edit"))
    with pytest.raises(ValueError, match="logprobs="):
        jt.ingest([1], step_tokens=[1])
    counters = t.counter_source()
    assert counters["active_requests"] == jt.counter_source()["active_requests"] == 1
    assert counters["finished_pending"] == 0
    t.ingest([1], step_tokens=[3], logprobs=[-0.5])
    t.reset()
    assert t.active_requests == 0 and int(t.n_keys) == 0
