"""torcheval_tpu_torch's ``elastic.ElasticSession`` against the JAX
package's: the crash matrix (every two-phase-commit crash point), the
filesystem faults, retention, payloads, the async writer and its
dedicated communicator, world-size-change resumes over ``ThreadWorld``,
survivor re-formation, and bundles crossing between the packages.

A resumed run must give the uninterrupted run's state bitwise. Across
packages the shard blob and ``MANIFEST.json`` are compared byte for byte,
a bundle written by either package restores in the other, and the
restored-and-finished state equals the other package's uninterrupted run
bitwise (counts and buffers); computed values are held to rtol 1e-6 (the
two packages compute AUROC with different op sequences). The world-size
cases run the same merge-order oracle as the JAX package's tests.
"""

from __future__ import annotations

import hashlib
import os
import sys
import warnings

import jax
import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as JM
from torcheval_tpu import elastic as jelastic
from torcheval_tpu.metrics import toolkit as jtoolkit
from torcheval_tpu.utils import test_utils as jtu
import torcheval_tpu_torch.metrics as TM
from torcheval_tpu_torch import distributed as tdist
from torcheval_tpu_torch import elastic
from torcheval_tpu_torch.elastic import (
    CRASH_POINTS,
    MANIFEST_NAME,
    SCHEMA_VERSION,
    ElasticSession,
    RestoreResult,
    _assign_shards,
    load_shard_states,
    newest_committed_generation,
)
from torcheval_tpu_torch.metrics.toolkit import clone_metric, get_synced_metric, sync_and_compute
from torcheval_tpu_torch.resilience import ResilientGroup
from torcheval_tpu_torch.utils.test_utils import (
    FaultInjectionGroup,
    FaultSpec,
    InjectedCrash,
    SnapshotCrashPlan,
    ThreadWorld,
    corrupt_manifest_digest,
    corrupt_shard,
    truncate_shard,
)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CPU = "cpu"
STEPS = 10
INTERVAL = 3
TU = sys.modules["torcheval_tpu_torch.utils.test_utils"]


def _batches(seed, steps=STEPS):
    rng = np.random.default_rng(seed)
    return [(np.float32(rng.uniform(size=(8, 4))), rng.integers(0, 4, 8)) for _ in range(steps)]


def _fresh(P=TM):
    kw = {"device": CPU} if P is TM else {}
    return {"acc": P.MulticlassAccuracy(**kw), "auroc": P.BinaryAUROC(**kw)}


def _feed(metrics, batch):
    scores, target = batch
    metrics["acc"].update(scores, target)
    metrics["auroc"].update(scores[:, 0], (target == 0).astype(np.float32))


def _values(metrics):
    return {k: np.asarray(m.compute()) for k, m in metrics.items()}


def _assert_bit_identical(got, want):
    for name in want:
        assert np.array_equal(got[name], want[name]), name


def _oracle(batches):
    metrics = _fresh()
    for batch in batches:
        _feed(metrics, batch)
    return _values(metrics)


def _resume_and_finish(directory, batches, *, interval=INTERVAL):
    metrics = _fresh()
    session = ElasticSession(metrics, directory, interval=interval)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        restored = session.restore()
    for step, batch in enumerate(batches):
        if not session.fence(step):
            continue
        _feed(metrics, batch)
        session.step_done(step)
    session.close()
    return metrics, restored


def test_names_and_constants_match_jax():
    assert CRASH_POINTS == jelastic.CRASH_POINTS
    assert MANIFEST_NAME == jelastic.MANIFEST_NAME
    assert SCHEMA_VERSION == jelastic.SCHEMA_VERSION
    assert RestoreResult._fields == jelastic.RestoreResult._fields
    for old in range(1, 9):
        for new in range(1, 9):
            assert _assign_shards(old, new) == jelastic._assign_shards(old, new)


# ------------------------------------------------------------ crash matrix


@pytest.mark.parametrize("point", CRASH_POINTS)
@pytest.mark.parametrize("at_snapshot", [0, 1])
def test_crash_matrix_resumes_bit_identical(tmp_path, point, at_snapshot):
    batches = _batches(11)
    metrics = _fresh()
    plan = SnapshotCrashPlan(point, at_snapshot=at_snapshot)
    session = ElasticSession(metrics, str(tmp_path), interval=INTERVAL, fault_hook=plan)
    with pytest.raises(InjectedCrash):
        for step, batch in enumerate(batches):
            _feed(metrics, batch)
            session.step_done(step)
    assert plan.crashed
    resumed, restored = _resume_and_finish(str(tmp_path), batches)
    _assert_bit_identical(_values(resumed), _oracle(batches))
    assert resumed["auroc"].num_samples == STEPS * 8
    assert (restored is not None) == (point == "post-manifest" or at_snapshot > 0)


def test_no_partial_generation_is_ever_loaded(tmp_path):
    batches = _batches(12)
    metrics = _fresh()
    plan = SnapshotCrashPlan("pre-manifest", at_snapshot=1)
    session = ElasticSession(metrics, str(tmp_path), interval=INTERVAL, fault_hook=plan)
    with pytest.raises(InjectedCrash):
        for step, batch in enumerate(batches):
            _feed(metrics, batch)
            session.step_done(step)
    gen_dirs = sorted(p for p in os.listdir(tmp_path) if p.startswith("gen-"))
    assert len(gen_dirs) == 2
    assert not os.path.exists(tmp_path / gen_dirs[1] / MANIFEST_NAME)
    assert newest_committed_generation(str(tmp_path))[0] == 0
    _, restored = _resume_and_finish(str(tmp_path), batches)
    assert restored.generation == 0 and restored.step == INTERVAL


@pytest.mark.parametrize(
    "fault",
    [lambda d, g: truncate_shard(d, g), lambda d, g: corrupt_shard(d, g),
     lambda d, g: corrupt_manifest_digest(d, g)],
    ids=["truncated-shard", "corrupt-shard", "corrupt-manifest-digest"],
)
def test_fs_fault_falls_back_one_generation(tmp_path, fault):
    batches = _batches(13)
    metrics = _fresh()
    session = ElasticSession(metrics, str(tmp_path), interval=INTERVAL, retention=3)
    for step, batch in enumerate(batches):
        _feed(metrics, batch)
        session.step_done(step)
    session.close()
    newest = newest_committed_generation(str(tmp_path))[0]
    fault(str(tmp_path), newest)
    with pytest.raises(RuntimeError):
        load_shard_states(os.path.join(str(tmp_path), f"gen-{newest:08d}"), 0)
    resumed, restored = _resume_and_finish(str(tmp_path), batches)
    assert restored.generation == newest - 1
    _assert_bit_identical(_values(resumed), _oracle(batches))
    assert resumed["auroc"].num_samples == STEPS * 8


def test_double_resume_counts_nothing_twice(tmp_path):
    batches = _batches(14)
    metrics = _fresh()
    session = ElasticSession(metrics, str(tmp_path), interval=INTERVAL)
    for step, batch in enumerate(batches[:5]):
        _feed(metrics, batch)
        session.step_done(step)
    session.close()
    m1 = _fresh()
    s1 = ElasticSession(m1, str(tmp_path), interval=INTERVAL)
    r1 = s1.restore()
    assert r1.step == INTERVAL
    _feed(m1, batches[r1.step])
    s1.step_done(r1.step)
    resumed, r2 = _resume_and_finish(str(tmp_path), batches)
    assert r2.generation == r1.generation and r2.step == r1.step
    _assert_bit_identical(_values(resumed), _oracle(batches))


def test_out_of_order_step_is_rejected(tmp_path):
    metrics = _fresh()
    session = ElasticSession(metrics, str(tmp_path), interval=INTERVAL)
    for step, batch in enumerate(_batches(15)[:5]):
        _feed(metrics, batch)
        session.step_done(step)
    session.close()
    s2 = ElasticSession(_fresh(), str(tmp_path), interval=INTERVAL)
    s2.restore()
    with pytest.raises(RuntimeError, match="fence"):
        s2.step_done(0)


def test_retention_rotates_old_generations(tmp_path):
    metrics = _fresh()
    session = ElasticSession(metrics, str(tmp_path), interval=2, retention=2)
    for step, batch in enumerate(_batches(16)):
        _feed(metrics, batch)
        session.step_done(step)
    session.close()
    assert sorted(p for p in os.listdir(tmp_path) if p.startswith("gen-")) == [
        "gen-00000003", "gen-00000004"]


def test_restore_returns_none_on_fresh_directory(tmp_path):
    session = ElasticSession(_fresh(), str(tmp_path))
    assert session.restore() is None
    assert session.cursor == 0 and session.fence(0)
    assert newest_committed_generation(str(tmp_path / "missing")) is None


def test_payload_rides_the_bundle(tmp_path):
    metrics = _fresh()
    session = ElasticSession(metrics, str(tmp_path), interval=2)
    for step, batch in enumerate(_batches(17)[:4]):
        _feed(metrics, batch)
        session.step_done(step, payload={"iterator": step})
    session.close()
    restored = ElasticSession(_fresh(), str(tmp_path), interval=2).restore()
    assert restored.payload == {"iterator": 3}
    assert restored.payloads == ({"iterator": 3},)


def test_payload_is_retained_until_the_next_snapshot(tmp_path):
    metrics = _fresh()
    session = ElasticSession(metrics, str(tmp_path), interval=4)
    for step, batch in enumerate(_batches(20)[:4]):
        _feed(metrics, batch)
        session.step_done(step, payload={"it": 1} if step == 1 else None)
    session.close()
    assert ElasticSession(_fresh(), str(tmp_path), interval=4).restore().payload == {"it": 1}


def test_writer_recoverable_error_keeps_collective_lockstep(tmp_path):
    metrics = _fresh()
    session = ElasticSession(metrics, str(tmp_path), interval=INTERVAL, async_writer=True)
    real_write = session._write_bundle
    failed = []

    def flaky_write(generation, *args):
        if generation == 0 and not failed:
            failed.append(generation)
            raise OSError("no space left on device")
        return real_write(generation, *args)

    session._write_bundle = flaky_write
    session._writer._write_bundle = flaky_write
    ferried = []
    for step, batch in enumerate(_batches(24)):
        _feed(metrics, batch)
        try:
            session.step_done(step)
        except OSError as e:
            ferried.append(e)
            session.step_done(step)
    session.close()
    assert len(ferried) == 1 and "no space left" in str(ferried[0])
    assert newest_committed_generation(str(tmp_path))[0] > 0
    assert not os.path.exists(tmp_path / "gen-00000000" / MANIFEST_NAME)


def test_local_replica_group_is_rejected(tmp_path):
    with pytest.raises(TypeError, match="LocalReplicaGroup"):
        ElasticSession(_fresh(), str(tmp_path),
                       process_group=tdist.LocalReplicaGroup([torch.device(CPU)]))


@pytest.mark.parametrize("rider", ["federation", "plane"])
def test_federation_and_plane_riders_wait_for_their_modules(tmp_path, rider):
    with pytest.raises(NotImplementedError, match="None"):
        ElasticSession(_fresh(), str(tmp_path), **{rider: object()})
    ElasticSession(_fresh(), str(tmp_path), **{rider: None}).close()


def test_bad_interval_and_retention_are_rejected(tmp_path):
    with pytest.raises(ValueError, match="interval"):
        ElasticSession(_fresh(), str(tmp_path), interval=0)
    with pytest.raises(ValueError, match="retention"):
        ElasticSession(_fresh(), str(tmp_path), retention=0)
    with pytest.raises(TypeError, match="Metric"):
        ElasticSession({}, str(tmp_path))
    session = ElasticSession(_fresh(), str(tmp_path))
    session.close()
    with pytest.raises(RuntimeError, match="closed"):
        session.step_done()


# ------------------------------------------------------------- async mode


def test_async_snapshots_restore_bit_identical(tmp_path):
    batches = _batches(18)
    metrics = _fresh()
    with ElasticSession(metrics, str(tmp_path), interval=INTERVAL, async_writer=True) as session:
        for step, batch in enumerate(batches[:7]):
            _feed(metrics, batch)
            session.step_done(step)
        session.drain()
    resumed, restored = _resume_and_finish(str(tmp_path), batches)
    assert restored.step == 6
    _assert_bit_identical(_values(resumed), _oracle(batches))


def test_async_snapshot_holds_the_state_of_its_step(tmp_path):
    """The async writer copies the clones taken at the snapshot, never a
    later in-place update (donation forced on, so updates write the live
    states in place)."""
    from torcheval_tpu_torch import config

    batches = _batches(25)
    with config.update_donation(True):
        metrics = _fresh()
        session = ElasticSession(metrics, str(tmp_path), interval=2, async_writer=True)
        for step, batch in enumerate(batches[:2]):
            _feed(metrics, batch)
            session.step_done(step)
        for batch in batches[2:]:  # keep updating while the writer works
            _feed(metrics, batch)
        session.close()
    resumed, restored = _resume_and_finish(str(tmp_path), batches[:2], interval=2)
    assert restored.step == 2
    _assert_bit_identical(_values(resumed), _oracle(batches[:2]))


def test_async_crash_is_ferried_to_close(tmp_path):
    batches = _batches(19)
    metrics = _fresh()
    plan = SnapshotCrashPlan("pre-manifest", at_snapshot=1)
    session = ElasticSession(metrics, str(tmp_path), interval=INTERVAL, async_writer=True,
                             fault_hook=plan)
    with pytest.raises(InjectedCrash):
        for step, batch in enumerate(batches):
            _feed(metrics, batch)
            session.step_done(step)
        session.close()
    assert plan.crashed
    resumed, restored = _resume_and_finish(str(tmp_path), batches)
    assert restored.generation == 0
    _assert_bit_identical(_values(resumed), _oracle(batches))


def test_restore_quarantines_unusable_newer_generations(tmp_path):
    batches = _batches(21)
    metrics = _fresh()
    session = ElasticSession(metrics, str(tmp_path), interval=INTERVAL, retention=2)
    for step, batch in enumerate(batches):
        _feed(metrics, batch)
        session.step_done(step)
    session.close()
    newest = newest_committed_generation(str(tmp_path))[0]
    corrupt_shard(str(tmp_path), newest)
    probe = ElasticSession(_fresh(), str(tmp_path), interval=INTERVAL)
    with pytest.warns(RuntimeWarning, match="unusable"):
        restored = probe.restore()
    assert restored.generation == newest - 1
    assert not os.path.exists(tmp_path / f"gen-{newest:08d}")
    probe.close()
    resumed, restored = _resume_and_finish(str(tmp_path), batches)
    assert restored.generation == newest - 1
    _assert_bit_identical(_values(resumed), _oracle(batches))


def test_rank_scanning_after_the_quarantine_numbers_past_it(tmp_path):
    """The leader removes an unusable generation during its restore; a
    peer whose restore scans after the removal never sees it, and must
    still continue the numbering above it (a quarantine marker), or the
    two ranks' next snapshots name different generations."""
    batches = _batches(21)
    metrics = _fresh()
    session = ElasticSession(metrics, str(tmp_path), interval=INTERVAL)
    for step, batch in enumerate(batches):
        _feed(metrics, batch)
        session.step_done(step)
    session.close()
    newest = newest_committed_generation(str(tmp_path))[0]
    corrupt_shard(str(tmp_path), newest)
    views = ThreadWorld(2).views
    leader = ElasticSession(_fresh(), str(tmp_path), process_group=views[0], interval=INTERVAL)
    with pytest.warns(RuntimeWarning, match="unusable"):
        assert leader.restore().generation == newest - 1
    assert not os.path.exists(tmp_path / f"gen-{newest:08d}")
    late = ElasticSession(_fresh(), str(tmp_path), process_group=views[1], interval=INTERVAL)
    assert late.restore().generation == newest - 1
    assert late._next_gen == leader._next_gen == newest + 1


def test_generation_divergence_fails_loudly_at_commit(tmp_path):
    directory = str(tmp_path)

    def body(g):
        metrics = _fresh()
        session = ElasticSession(metrics, directory, process_group=g, interval=100)
        if g.rank == 1:
            session._next_gen += 1
        _feed(metrics, _batches(22)[0])
        session.step_done(0)
        if g.rank == 0:
            with pytest.raises(RuntimeError, match="generations \\[0, 1\\]"):
                session.snapshot()
        else:
            session.snapshot()
        return True

    assert ThreadWorld(2, timeout=10.0).run(body) == [True, True]


def _per_rank_batches(world, steps, seed):
    rng = np.random.default_rng(seed)
    return [[(np.float32(rng.uniform(size=(8, 4))), rng.integers(0, 4, 8)) for _ in range(steps)]
            for _ in range(world)]


def test_async_snapshots_use_a_dedicated_communicator(tmp_path):
    directory = str(tmp_path)
    per_rank = _per_rank_batches(2, 9, seed=23)

    def body(g):
        metrics = _fresh()
        session = ElasticSession(metrics, directory, process_group=g, interval=3,
                                 async_writer=True)
        assert session._comm is not g
        values = []
        for step in range(9):
            _feed(metrics, per_rank[g.rank][step])
            session.step_done(step)
            values.append(float(sync_and_compute(metrics["acc"], g)))
        session.close()
        return values

    results = ThreadWorld(2, timeout=10.0).run(body)
    assert results[0] == results[1]

    def body_restore(g):
        return ElasticSession(_fresh(), directory, process_group=g).restore().step

    assert ThreadWorld(2, timeout=10.0).run(body_restore) == [9, 9]


# ------------------------------------------------- world-size-change resume


def _world_change(tmp_path, old_world, new_world, P=TM, writer=None, reader=None):
    """Write at ``old_world`` with package ``writer``, restore at
    ``new_world`` with ``reader`` (each a (metrics module, elastic,
    toolkit, test_utils) tuple), and return the readers' results."""
    pre = _per_rank_batches(old_world, 6, seed=100 + old_world)
    post = _per_rank_batches(new_world, 4, seed=200 + new_world)
    directory = str(tmp_path)
    writer = writer or (TM, elastic, None, TU)
    reader = reader or (TM, elastic, None, TU)

    def body_old(g):
        metrics = _fresh(writer[0])
        session = writer[1].ElasticSession(metrics, directory, process_group=g, interval=3)
        for step in range(6):
            _feed(metrics, pre[g.rank][step])
            session.step_done(step)
        session.close()

    writer[3].ThreadWorld(old_world, timeout=20.0).run(body_old)

    def body_new(g):
        metrics = _fresh(reader[0])
        session = reader[1].ElasticSession(metrics, directory, process_group=g, interval=3)
        restored = session.restore()
        for step in range(restored.step, restored.step + 4):
            _feed(metrics, post[g.rank][step - restored.step])
            session.step_done(step)
        session.close()
        return restored, metrics

    return reader[3].ThreadWorld(new_world, timeout=20.0).run(body_new), pre, post


def _redistributed_oracle(pre, post, old_world, new_world, P=TM):
    old = [_fresh(P) for _ in range(old_world)]
    for rank in range(old_world):
        for batch in pre[rank]:
            _feed(old[rank], batch)
    new = []
    for assigned in _assign_shards(old_world, new_world):
        metrics = _fresh(P)
        for name in metrics:
            peers = [clone_metric(old[r][name]) for r in assigned]
            if peers:
                metrics[name] = peers[0]
                metrics[name].merge_state(peers[1:])
        new.append(metrics)
    for rank in range(new_world):
        for batch in post[rank]:
            _feed(new[rank], batch)
    return new


@pytest.mark.parametrize("old_world,new_world", [(4, 2), (2, 4)])
def test_world_size_change_matches_the_merge_order_oracle(tmp_path, old_world, new_world):
    results, pre, post = _world_change(tmp_path, old_world, new_world)
    new = _redistributed_oracle(pre, post, old_world, new_world)
    merged = {name: clone_metric(m) for name, m in new[0].items()}
    for name in merged:
        merged[name].merge_state([new[r][name] for r in range(1, new_world)])
    oracle = _values(merged)
    for rank, (restored, metrics) in enumerate(results):
        assert restored.world_size == old_world and restored.step == 6
        for name in metrics:
            _assert_same_logical(metrics[name], new[rank][name])
    all_assigned = [r for res, _ in results for r in res.assigned_ranks]
    assert all_assigned == list(range(old_world))
    # a sync across the new world equals the oracle's merge
    synced = ThreadWorld(new_world, timeout=20.0).run(
        lambda g: _values({k: get_synced_metric(m, g) for k, m in results[g.rank][1].items()}))
    for values in synced:
        _assert_bit_identical(values, oracle)


def _logical(m):
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in m._sync_state_dict().items()}


def _assert_same_logical(a, b):
    sa, sb = _logical(a), _logical(b)
    assert sa.keys() == sb.keys()
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and np.array_equal(sa[k], sb[k]), k


# ------------------------------------------------- survivor re-formation


def _metric_for(rank):
    rng = np.random.default_rng(rank)
    m = TM.MulticlassAccuracy(device=CPU)
    m.update(np.float32(rng.uniform(size=(16, 4))), rng.integers(0, 4, 16))
    return m


def test_reform_after_consecutive_degraded_syncs():
    def body(g):
        if g.rank == 3:
            for _ in range(2):
                get_synced_metric(_metric_for(g.rank), g)
            return None
        group = ResilientGroup(FaultInjectionGroup(g, dead_ranks={3}), timeout=2.0,
                               policy="quorum", reform_after=2)
        provs = []
        for _ in range(4):
            synced = get_synced_metric(_metric_for(g.rank), group)
            provs.append(synced.sync_provenance)
        return provs, group.health.as_dict(), group.ranks, synced.compute()

    results = ThreadWorld(4, timeout=10.0).run(body)
    oracle = _metric_for(0)
    oracle.merge_state([_metric_for(1), _metric_for(2)])
    for rank in range(3):
        provs, health, ranks, value = results[rank]
        assert provs[0].degraded and provs[0].world_size == 4
        assert provs[0].ranks == (0, 1, 2) and not provs[0].reformed
        assert provs[1].degraded and provs[1].world_size == 4 and provs[1].reformed
        for p in provs[2:]:
            assert not p.degraded and p.world_size == 3 and p.ranks == (0, 1, 2) and p.reformed
        assert health["reforms"] == 1 and health["reformed_to"] == [0, 1, 2]
        assert health["degraded_syncs"] == 2 and health["full_syncs"] == 2
        assert ranks == (0, 1, 2)
        assert torch.equal(value, oracle.compute())


def test_reform_requires_same_missing_ranks():
    def body(g):
        chaos = FaultInjectionGroup(g)
        group = ResilientGroup(chaos, timeout=2.0, policy="quorum", reform_after=2)
        chaos.faults.extend([FaultSpec(call=0, kind="drop", rank=1, times=2),
                             FaultSpec(call=2, kind="drop", rank=2, times=2)])
        provs = []
        for _ in range(2):
            provs.append(get_synced_metric(_metric_for(g.rank), group).sync_provenance)
        return provs, group.health.as_dict()

    results = ThreadWorld(3, timeout=10.0).run(body)
    for provs, health in results:
        assert all(not p.reformed for p in provs)
        assert health["reforms"] == 0 and health["consecutive_missing_count"] <= 1
    provs0, _ = results[0]
    assert provs0[0].ranks != provs0[1].ranks and all(p.degraded for p in provs0)


def test_reform_composes_with_elastic_resume(tmp_path):
    directory = str(tmp_path)
    pre = _per_rank_batches(4, 4, seed=42)

    def body(g):
        metrics = _fresh()
        if g.rank == 3:
            for _ in range(2):
                get_synced_metric(_metric_for(g.rank), g)
            return None
        group = ResilientGroup(FaultInjectionGroup(g, dead_ranks={3}), timeout=2.0,
                               policy="quorum", reform_after=2)
        for _ in range(2):
            get_synced_metric(_metric_for(g.rank), group)
        assert group.world_size == 3
        session = ElasticSession(metrics, directory, process_group=group, interval=2)
        for step in range(4):
            _feed(metrics, pre[g.rank][step])
            session.step_done(step)
        session.close()
        return sync_and_compute(metrics["acc"], group)

    ThreadWorld(4, timeout=10.0).run(body)

    def body_new(g):
        metrics = _fresh()
        restored = ElasticSession(metrics, directory, process_group=g).restore()
        return restored, get_synced_metric(metrics["acc"], g).compute()

    oracle = _fresh()
    for rank in range(3):
        for step in range(4):
            _feed(oracle, pre[rank][step])
    for restored, value in ThreadWorld(2, timeout=10.0).run(body_new):
        assert restored.world_size == 3 and restored.step == 4
        assert torch.equal(value, oracle["acc"].compute())


def test_reset_clears_stale_sync_provenance(tmp_path):
    def body(g):
        m = _metric_for(g.rank)
        if g.rank == 2:
            get_synced_metric(m, g)
            return None
        group = ResilientGroup(FaultInjectionGroup(g, dead_ranks={2}), timeout=2.0,
                               policy="quorum")
        synced = get_synced_metric(m, group)
        assert synced.sync_provenance.degraded
        synced.reset()
        return hasattr(synced, "sync_provenance")

    assert ThreadWorld(3, timeout=10.0).run(body)[:2] == [False, False]
    metrics = _fresh()
    ElasticSession(metrics, str(tmp_path), interval=1).step_done(0)
    metrics["acc"].sync_provenance = "stale"
    ElasticSession(metrics, str(tmp_path)).restore()
    assert not hasattr(metrics["acc"], "sync_provenance")


# ------------------------------------------------ bundles across packages

JAX_PKG = (JM, jelastic, jtoolkit, jtu)
PORT_PKG = (TM, elastic, None, TU)


def _single_bundle(P, E, directory, batches, interval=INTERVAL):
    metrics = _fresh(P)
    session = E.ElasticSession(metrics, directory, interval=interval)
    for step, batch in enumerate(batches):
        _feed(metrics, batch)
        session.step_done(step, payload={"it": step})
    session.close()
    return metrics


def test_same_state_writes_byte_identical_bundles(tmp_path):
    batches = _batches(31, steps=7)
    _single_bundle(JM, jelastic, str(tmp_path / "jax"), batches)
    _single_bundle(TM, elastic, str(tmp_path / "torch"), batches)
    for gen in (0, 1):
        for name in (MANIFEST_NAME, "shard-00000.bin"):
            a = (tmp_path / "jax" / f"gen-{gen:08d}" / name).read_bytes()
            b = (tmp_path / "torch" / f"gen-{gen:08d}" / name).read_bytes()
            assert hashlib.sha256(a).hexdigest() == hashlib.sha256(b).hexdigest(), (gen, name)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_bundle_restores_in_the_other_package(tmp_path, direction):
    batches = _batches(32)
    writer, reader = (JAX_PKG, PORT_PKG) if direction == "jax_to_port" else (PORT_PKG, JAX_PKG)
    _single_bundle(writer[0], writer[1], str(tmp_path), batches[:7])
    metrics = _fresh(reader[0])
    session = reader[1].ElasticSession(metrics, str(tmp_path), interval=INTERVAL)
    restored = session.restore()
    assert restored.step == 6 and restored.payload == {"it": 5}
    for step, batch in enumerate(batches):
        if session.fence(step):
            _feed(metrics, batch)
            session.step_done(step)
    session.close()
    # the other package's uninterrupted run
    uninterrupted = _fresh(writer[0])
    for batch in batches:
        _feed(uninterrupted, batch)
    for name in metrics:
        a, b = _logical(metrics[name]), _logical(uninterrupted[name])
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (name, k)
        np.testing.assert_allclose(np.asarray(metrics[name].compute()),
                                   np.asarray(uninterrupted[name].compute()), rtol=1e-6)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_bundle_restores_in_the_other_package_at_4_to_2(tmp_path, direction):
    writer, reader = (JAX_PKG, PORT_PKG) if direction == "jax_to_port" else (PORT_PKG, JAX_PKG)
    results, pre, post = _world_change(tmp_path, 4, 2, writer=writer, reader=reader)
    # the writer package's uninterrupted run, in the same merge order
    new = _redistributed_oracle(pre, post, 4, 2, P=writer[0])
    for rank, (restored, metrics) in enumerate(results):
        assert restored.world_size == 4 and restored.step == 6
        assert restored.assigned_ranks == ((0, 1), (2, 3))[rank]
        for name in metrics:
            a, b = _logical(metrics[name]), _logical(new[rank][name])
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (name, k)


def test_digest_of_a_bundle_matches_across_packages(tmp_path):
    batches = _batches(33, steps=4)
    _single_bundle(TM, elastic, str(tmp_path), batches, interval=4)
    gen_dir = newest_committed_generation(str(tmp_path))[1]
    t_manifest, t_tree = load_shard_states(gen_dir, 0)
    j_manifest, j_tree = jelastic.load_shard_states(gen_dir, 0)
    assert t_manifest == j_manifest
    assert t_tree["step"] == j_tree["step"] == 4


# ------------------------------------------------------ the card phase, small


def test_phase_elastic_small_on_cpu():
    import chip_smoke

    out = chip_smoke.phase_elastic(
        "cpu", n=40 * 512 + 100, batch=512, num_bins=64, interval=3, exact_per_rank=2 * 512,
        crash_timeout=2.0, deadline=1.0, timing_steps=6, timing_interval=2, mp_steps=0,
        classify_n=700, num_classes=20, cls_batch=64, variable=(64, 64, 60, 37, 32, 17, 7, 3),
        seed=3)
    assert out["k1_launches"]["streaming_updates"] == [72, 68]
    assert out["resilience"]["gathers"]["bare"] == out["resilience"]["gathers"]["resilient"]
    assert out["resilience"]["reform_provenance"][-1] == [[0, 1, 2], 3, False, True]
    assert max(out["rel_err_vs_float64"].values()) <= 1e-5
    assert out["bucket"]["updates_bitwise"] > 0
