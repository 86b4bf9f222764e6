"""Cross-region federation (``torcheval_tpu_torch.federation``) against the
JAX package.

The same seeded per-rank streams go through a ``ThreadWorld`` federation
of each package on the same chaos schedule (``ChaosLinkTransport`` over an
``InProcessLinkBus``): healthy rounds, a partition, a heal. Every round's
provenance (regions merged, dark flags, staleness) is the same in both,
the healed result is bitwise the flat sync of the same streams, and the
ledgers (packed snapshots, acked and merged epochs) are the same bytes.
Also: the word-delta codec bitwise to the JAX package's, the ledger
cross-loading both ways through numpy, ``KVLinkTransport`` over a
``torch.distributed.FileStore``, the int8 rung, ``/healthz`` reading
``stale-region`` while a region is dark, and ``ElasticSession(federation=,
plane=)`` saving and restoring the ledger and invalidating the plane.
"""

from __future__ import annotations

import os
import pickle
import threading
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torcheval_tpu.federation as JF
import torcheval_tpu.metrics as JM
import torcheval_tpu.utils.test_utils as JU
import torcheval_tpu_torch.federation as PF
import torcheval_tpu_torch.metrics as PM
import torcheval_tpu_torch.utils.test_utils as PU
from torcheval_tpu import config as jconfig
from torcheval_tpu.metrics.toolkit import sync_and_compute_collection as j_sync
from torcheval_tpu_torch import config as pconfig
from torcheval_tpu_torch.metrics.toolkit import sync_and_compute_collection as p_sync

CPU = "cpu"
REGIONS_2X2 = [("us", (0, 1)), ("eu", (2, 3))]
REGIONS_1X2 = [("us", (0,)), ("eu", (1,))]

JAX = SimpleNamespace(F=JF, M=JM, U=JU, sync=j_sync, conv=jnp.asarray, kw={}, config=jconfig)
PORT = SimpleNamespace(F=PF, M=PM, U=PU, sync=p_sync, conv=torch.from_numpy,
                       kw={"device": CPU}, config=pconfig)


@pytest.fixture(autouse=True)
def _federation_cleanup():
    yield
    from torcheval_tpu.obs.counters import default_registry as jreg
    from torcheval_tpu_torch.obs.counters import default_registry as preg

    for mod, reg in ((JF, jreg), (PF, preg)):
        with mod._CURRENT_LOCK:
            mod._CURRENT = None
        reg().unregister("federation")


def _make(P):
    return {
        "acc": P.M.MulticlassAccuracy(**P.kw),
        "sum": P.M.Sum(**P.kw),
        "max": P.M.Max(**P.kw),
        "cat": P.M.Cat(**P.kw),
        "cm": P.M.MulticlassConfusionMatrix(64, **P.kw),
    }


def _update(P, coll, rank, rnd):
    """Integer-valued float data: exact addition in any fold order."""
    rng = np.random.default_rng(1000 * rank + rnd)
    x = rng.random((8, 64)).astype(np.float32)
    t = rng.integers(0, 64, 8)
    s = rng.integers(0, 16, 8).astype(np.float32)
    coll["acc"].update(P.conv(x), P.conv(t))
    coll["sum"].update(P.conv(s))
    coll["max"].update(P.conv(s))
    coll["cat"].update(P.conv(s))
    coll["cm"].update(P.conv(x), P.conv(t))


def _values(merged):
    out = {}
    for k, m in merged.items():
        v = m.compute()
        out[k] = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


def _flat_oracle(P, world_size, rounds):
    world = P.U.ThreadWorld(world_size)

    def run(g):
        coll = _make(P)
        for rnd in range(rounds):
            _update(P, coll, g.rank, rnd)
        return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
                for k, v in P.sync(coll, g).items()}

    return world.run(run)[0]


def _prov_key(prov):
    return (
        prov.merged_regions, prov.degraded, prov.epoch,
        tuple((s.name, s.epoch, s.staleness_epochs, s.dark, s.is_self) for s in prov.regions),
    )


def _run(P, world_size, regions, rounds, *, settle=3, round_hook=None, partition_after=2,
         faults=()):
    """One federation world: a round is update, barrier, ``round_hook``
    (rank 0), barrier, then each region's ``federate`` in turn, a barrier
    after each (so what a leader's poll finds is the same in every run:
    deliveries land on round boundaries)."""
    chaos = P.U.ChaosLinkTransport(P.F.InProcessLinkBus(), faults)
    world = P.U.ThreadWorld(world_size)
    barrier = threading.Barrier(world_size)
    feds, provs = {}, {}

    def run(g):
        fed = P.F.Federation(g, regions, transport=chaos, partition_after=partition_after)
        feds[g.rank] = fed
        coll = _make(P)
        merged = None
        for rnd in range(rounds + settle):
            if rnd < rounds:
                _update(P, coll, g.rank, rnd)
            barrier.wait()
            if g.rank == 0 and round_hook is not None:
                round_hook(chaos, rnd)
            barrier.wait()
            for name, ranks in regions:
                if g.rank in ranks:
                    merged = fed.federate(coll)
                barrier.wait()
            provs[(g.rank, rnd)] = _prov_key(fed.last_provenance)
        return _values(merged)

    return world.run(run), feds, provs


def _partition(start, end):
    def hook(chaos, rnd):
        if rnd == start:
            chaos.partition_both("us", "eu")
        if rnd == end:
            chaos.heal_both("us", "eu")
    return hook


def test_all_lists_match():
    assert PF.__all__ == JF.__all__
    import torcheval_tpu.utils.test_utils.fault_injection as jfi
    import torcheval_tpu_torch.utils.test_utils.fault_injection as pfi

    assert pfi.__all__ == jfi.__all__
    added = {"ChaosLinkTransport", "LinkFaultSpec", "KILL_POINTS", "KillGroup", "KillSchedule",
             "KillSpec"}
    assert added <= set(PU.__all__) and added <= set(JU.__all__)


@pytest.mark.parametrize("size", [0, 1, 3, 4, 1001, 4096])
def test_word_delta_codec_bitwise_to_jax(size):
    rng = np.random.default_rng(size)
    base = rng.integers(0, 256, size).astype(np.uint8)
    cur = base.copy()
    if size:
        cur[rng.choice(size, max(1, size // 50), replace=False)] ^= 0x5A
    dj, dp = JF.encode_delta(base, cur), PF.encode_delta(base, cur)
    assert (dj is None) == (dp is None)
    if dp is not None:
        assert dp["size"] == dj["size"]
        assert np.array_equal(dp["idx"], dj["idx"]) and np.array_equal(dp["words"], dj["words"])
        assert np.array_equal(PF.apply_delta(base, dj), cur)
        assert np.array_equal(JF.apply_delta(base, dp), cur)
    dense = (base ^ 0xFF).astype(np.uint8)
    assert PF.encode_delta(base, dense) is None and JF.encode_delta(base, dense) is None


def test_partition_heal_matches_jax_and_the_flat_sync():
    rounds, start, end = 8, 2, 6
    got, pfeds, pprovs = _run(PORT, 4, REGIONS_2X2, rounds, round_hook=_partition(start, end))
    want, jfeds, jprovs = _run(JAX, 4, REGIONS_2X2, rounds, round_hook=_partition(start, end))
    assert pprovs == jprovs
    oracle = _flat_oracle(PORT, 4, rounds)
    joracle = _flat_oracle(JAX, 4, rounds)
    for rank in range(4):
        for k in oracle:
            assert got[rank][k].tobytes() == oracle[k].tobytes(), (rank, k)
            assert got[rank][k].tobytes() == want[rank][k].tobytes(), (rank, k)
            assert oracle[k].tobytes() == joracle[k].tobytes(), k
    # while dark: degraded, eu dark with growing staleness
    mid = pprovs[(0, end - 1)]
    assert mid[0] == ("us",) and mid[1]
    eu = [r for r in mid[3] if r[0] == "eu"][0]
    assert eu[3] and eu[2] > 2
    h = pfeds[0].link_health("eu")
    assert h.partitions >= 1 and h.heals >= 1
    assert h.as_dict() == jfeds[0].link_health("eu").as_dict()
    # the leaders' ledgers are the same bytes in both packages
    for rank in (0, 2):
        lp, lj = pfeds[rank].ledger_payload(), jfeds[rank].ledger_payload()
        for led in (lp, lj):
            for link in led["links"].values():
                link.pop("merged_wall")
        assert lp == lj


def test_duplicates_and_reorder_are_discarded_as_in_jax():
    faults = [
        PU.LinkFaultSpec("us", "eu", 0, "duplicate", times=3),
        PU.LinkFaultSpec("eu", "us", 1, "reorder"),
        PU.LinkFaultSpec("us", "eu", 4, "delay", hold=2),
    ]
    jfaults = [JU.LinkFaultSpec(*f) for f in faults]
    got, pfeds, pprovs = _run(PORT, 2, REGIONS_1X2, 6, faults=faults)
    want, jfeds, jprovs = _run(JAX, 2, REGIONS_1X2, 6, faults=jfaults)
    assert pprovs == jprovs
    for rank in range(2):
        for k in got[rank]:
            assert got[rank][k].tobytes() == want[rank][k].tobytes()
    assert pfeds[1].link_health("us").duplicates >= 1
    assert pfeds[1].link_health("us").as_dict() == jfeds[1].link_health("us").as_dict()


def test_healthz_reads_stale_region_while_dark():
    from torcheval_tpu_torch.obs.server import healthz_payload

    hook = _partition(1, 99)
    _, feds, _ = _run(PORT, 2, REGIONS_1X2, 7, settle=0, round_hook=hook)
    with PF._CURRENT_LOCK:
        PF._CURRENT = feds[0]
    payload = healthz_payload()
    assert payload["status"] == "stale-region" and payload["healthy"] is False
    eu = [r for r in payload["federation"]["regions"] if r["name"] == "eu"][0]
    assert eu["dark"] and eu["staleness_epochs"] > feds[0].staleness_503
    counters = feds[0]._counter_source()
    assert counters["dark_regions"] == 1 and counters["region_staleness_epochs/eu"] > 2
    for fed in feds.values():
        fed.close()


def test_ledger_cross_loads_both_ways():
    _, pfeds, _ = _run(PORT, 2, REGIONS_1X2, 3)
    _, jfeds, _ = _run(JAX, 2, REGIONS_1X2, 3)
    for src, dst_pkg in ((pfeds[0], JAX), (jfeds[0], PORT)):
        payload = pickle.loads(pickle.dumps(src.ledger_payload()))
        world = dst_pkg.U.ThreadWorld(2)
        fed = dst_pkg.F.Federation(world.views[0], REGIONS_1X2,
                                   transport=dst_pkg.F.InProcessLinkBus())
        fed.load_ledger(payload)
        assert fed.ledger_payload() == payload
        assert fed._links["eu"].force_full
        fed.close()
    with pytest.warns(RuntimeWarning, match="layout mismatch"):
        fed = PF.Federation(PU.ThreadWorld(2).views[0], REGIONS_1X2,
                            transport=PF.InProcessLinkBus())
        fed.load_ledger({"schema": 1, "regions": [("x", (0,))], "epoch": 9})
    assert fed.epoch == 0
    fed.close()


def test_int8_rung_heal_is_epoch_idempotent_as_in_jax():
    """At the int8 rung a partitioned-then-healed run with duplicates ends
    bitwise where the fault-free run at that rung does, in both packages,
    and the two packages' results are the same bits."""
    faults = [PU.LinkFaultSpec("us", "eu", 0, "duplicate", times=4)]
    out = {}
    for name, P, fl in (("port", PORT, faults), ("jax", JAX, [JU.LinkFaultSpec(*f) for f in faults])):
        with P.config.wire_ladder_mode("int8"):
            chaotic, _, _ = _run(P, 4, REGIONS_2X2, 6, round_hook=_partition(2, 4), faults=fl)
            clean, _, _ = _run(P, 4, REGIONS_2X2, 6)
        out[name] = (chaotic, clean)
    for rank in range(4):
        for k in out["port"][0][rank]:
            c, f = out["port"][0][rank][k], out["port"][1][rank][k]
            assert c.tobytes() == f.tobytes(), (rank, k)
            assert c.tobytes() == out["jax"][0][rank][k].tobytes(), (rank, k)


def _file_store(tmp_path, name="kv"):
    return dist.FileStore(str(tmp_path / name), 1)


def test_kv_link_transport_over_a_file_store(tmp_path, monkeypatch):
    store = _file_store(tmp_path)
    monkeypatch.setattr(PF.KVLinkTransport, "_client", lambda self: store)
    a, b = PF.KVLinkTransport(tag="t", poll_timeout=2.0), PF.KVLinkTransport(tag="t", poll_timeout=2.0)
    a.register_peers("us", ["eu"])
    b.register_peers("eu", ["us"])
    assert b.poll("eu") == []
    a.post("us", "eu", b"one")
    a.post("us", "eu", b"two")
    assert b.poll("eu") == [b"one", b"two"]
    assert b.poll("eu") == []
    # a restarted sender resumes above the head; a restarted receiver walks
    # forward from it and skips consumed (deleted) keys
    a2 = PF.KVLinkTransport(tag="t", poll_timeout=2.0)
    a2.post("us", "eu", b"three")
    b2 = PF.KVLinkTransport(tag="t", poll_timeout=2.0)
    b2.register_peers("eu", ["us"])
    assert b2.poll("eu") == [b"three"]
    assert not store.check(["torcheval_fed/t/us->eu/0"])


def _kv_federation_rank(rank, path, out_dir, rounds):
    dist.init_process_group("gloo", store=dist.FileStore(path, 2), rank=rank, world_size=2)
    try:
        from torcheval_tpu_torch.distributed import MultiHostGroup

        g = MultiHostGroup()
        fed = PF.Federation(g, REGIONS_1X2, partition_after=3)
        assert isinstance(fed.transport, PF.KVLinkTransport)
        coll = _make(PORT)
        merged = None
        for rnd in range(rounds + 3):
            if rnd < rounds:
                _update(PORT, coll, rank, rnd)
            dist.barrier()
            merged = fed.federate(coll)
            dist.barrier()
        np.savez(os.path.join(out_dir, f"r{rank}.npz"), **_values(merged))
        fed.close()
    finally:
        dist.destroy_process_group()


def test_federation_over_processes_rides_the_store(tmp_path):
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    path = str(tmp_path / "store")
    procs = [ctx.Process(target=_kv_federation_rank, args=(r, path, str(tmp_path), 3))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(120)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    oracle = _flat_oracle(PORT, 2, 3)
    for r in range(2):
        got = np.load(tmp_path / f"r{r}.npz")
        for k in oracle:
            assert got[k].tobytes() == oracle[k].tobytes(), (r, k)


def test_elastic_session_carries_the_ledger_and_the_plane(tmp_path):
    from torcheval_tpu_torch.elastic import ElasticSession
    from torcheval_tpu_torch.syncplane import SyncPlane

    rounds = 3
    world = PU.ThreadWorld(2)
    barrier = threading.Barrier(2)
    captured = {}

    class TapBus(PF.InProcessLinkBus):
        def post(self, src, dst, blob):
            if pickle.loads(blob).get("kind") in ("full", "delta"):
                captured.setdefault((src, dst), []).append(blob)
            super().post(src, dst, blob)

    bus = TapBus()

    def phase1(g):
        fed = PF.Federation(g, REGIONS_1X2, transport=bus, partition_after=3)
        coll = _make(PORT)
        plane = SyncPlane(coll, g)
        session = ElasticSession(coll, str(tmp_path), process_group=g, interval=1000,
                                 federation=fed, plane=plane)
        for rnd in range(rounds):
            _update(PORT, coll, g.rank, rnd)
            barrier.wait()
            fed.federate(coll)
            barrier.wait()
        plane.publish()
        plane.run_round()
        session.snapshot()
        session.close()
        plane.close()
        fed.close()

    world.run(phase1)
    world2 = PU.ThreadWorld(2)
    bus2 = PF.InProcessLinkBus()
    barrier2 = threading.Barrier(2)
    feds2, invalidated = {}, {}

    def phase2(g):
        fed = PF.Federation(g, REGIONS_1X2, transport=bus2, partition_after=3)
        feds2[g.rank] = fed
        coll = _make(PORT)
        plane = SyncPlane(coll, g)
        plane.publish()
        plane.run_round()
        session = ElasticSession(coll, str(tmp_path), process_group=g, interval=1000,
                                 federation=fed, plane=plane)
        assert session.restore() is not None
        invalidated[g.rank] = plane.version == 0 and plane.read()["acc"].sync_provenance.version == 0
        peer = "eu" if g.rank == 0 else "us"
        assert fed._links[peer].merged_epoch > 0
        barrier2.wait()
        if g.rank == 1:  # re-deliver the oldest pre-crash us -> eu snapshot
            bus2.post("us", "eu", captured[("us", "eu")][0])
        barrier2.wait()
        merged = None
        for _ in range(3):
            barrier2.wait()
            merged = fed.federate(coll)
            barrier2.wait()
        session.close()
        plane.close()
        return _values(merged)

    results = world2.run(phase2)
    oracle = _flat_oracle(PORT, 2, rounds)
    for vals in results:
        for k, want in oracle.items():
            assert vals[k].tobytes() == want.tobytes(), k
    assert feds2[1].link_health("us").duplicates >= 1
    assert invalidated == {0: True, 1: True}
    # the shard's federation slot is the ledger, in numpy form
    from torcheval_tpu_torch.elastic import load_shard_states, newest_committed_generation

    _, gen_dir = newest_committed_generation(str(tmp_path))
    _, tree = load_shard_states(gen_dir, 0)
    led = tree["federation"]
    assert led["schema"] == 1 and led["region"] == "us" and led["epoch"] == rounds
    assert all(isinstance(raw, bytes) for _, raw in led["history"].values())
