"""Coordinated rank-loss recovery (``torcheval_tpu_torch.failover``) and the
scripted rank kills (``utils.test_utils.kill_schedule``) against the JAX
package.

The kill matrix of the JAX package's failover tests, run through both
packages on the same seeded keyed-CTR traffic over ``ThreadWorld(4)`` with
``KillGroup``: a kill on a committed generation boundary (an exact
``LossBound``, survivors bitwise the fault-free oracle, live rejoin back to
it, the ``detected -> reconstructed -> reformed -> rejoined`` event ladder,
``/healthz`` reading ``degraded-world``), a kill two steps past the
boundary (the bound counts those steps), a drain after the snapshot (one
epoch of lag, the dead outbox stripped), and every kill point with a plane
and a federation riding the domain. Each bound and each rebuilt state is
the JAX package's. Detection issues no collective; an admission-armed
table rescales its outbox budget to the survivor world and back. Last, a
spawned gloo world of 3 processes over a ``FileStore`` in which one
process exits after a sync: the survivors form their group inside
``distributed.members_only()`` (store-backed) and sync without it.
"""

from __future__ import annotations

import os
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torcheval_tpu.failover as JFO
import torcheval_tpu.metrics as JM
import torcheval_tpu.utils.test_utils as JU
import torcheval_tpu.utils.test_utils.kill_schedule as JK
import torcheval_tpu_torch.failover as PFO
import torcheval_tpu_torch.metrics as PM
import torcheval_tpu_torch.utils.test_utils as PU
import torcheval_tpu_torch.utils.test_utils.kill_schedule as PK
from torcheval_tpu import elastic as jel
from torcheval_tpu import federation as jfed
from torcheval_tpu import resilience as jres
from torcheval_tpu import syncplane as jplane
from torcheval_tpu import table as jtab
from torcheval_tpu.metrics import ShardContext as JShard
from torcheval_tpu.metrics import toolkit as jtk
from torcheval_tpu_torch import elastic as pel
from torcheval_tpu_torch import federation as pfed
from torcheval_tpu_torch import resilience as pres
from torcheval_tpu_torch import syncplane as pplane
from torcheval_tpu_torch import table as ptab
from torcheval_tpu_torch.metrics import toolkit as ptk
from torcheval_tpu_torch.metrics.shardspec import ShardContext as PShard

CPU = "cpu"
WORLD, VICTIM = 4, 2
REGIONS_2X2 = [("us", (0, 1)), ("eu", (2, 3))]

JAX = SimpleNamespace(FO=JFO, M=JM, U=JU, el=jel, fed=jfed, res=jres, plane=jplane, tab=jtab,
                      tk=jtk, Shard=JShard, kw={}, val=lambda x: x)
PORT = SimpleNamespace(FO=PFO, M=PM, U=PU, el=pel, fed=pfed, res=pres, plane=pplane, tab=ptab,
                       tk=ptk, Shard=PShard, kw={"device": CPU}, val=torch.from_numpy)


@pytest.fixture(autouse=True)
def _failover_cleanup():
    yield
    from torcheval_tpu.obs.counters import default_registry as jreg
    from torcheval_tpu_torch.obs.counters import default_registry as preg

    for mod, reg in ((JFO, jreg), (PFO, preg)):
        with mod._CURRENT_LOCK:
            mod._CURRENT = None
        reg().unregister("resilience")


def _batch(P, step, rank, pool=None, n=16):
    """Integer-valued CTR traffic (exact sums in any fold order)."""
    rng = np.random.default_rng(1000 + 17 * step + rank)
    keys = rng.integers(0, 60, n) if pool is None else np.asarray(pool)[rng.integers(0, len(pool), n)]
    clicks = rng.integers(0, 2, n).astype(np.float32)
    return keys, P.val(clicks), P.val(np.ones(n, np.float32))


def _table(P, rank, world=WORLD, **kw):
    return P.tab.MetricTable("ctr", shard=P.Shard(rank, world), **P.kw, **kw)


def _fault_free(P, steps, drains, *, skip=None, pool=None):
    def body(g):
        t = _table(P, g.rank)
        for step in range(steps):
            if skip and g.rank in skip and step >= skip[g.rank]:
                continue
            t.ingest(*_batch(P, step, g.rank, pool=pool))
        for _ in range(drains):
            P.tk.adopt_synced(t, g)
        return P.tk.sync_and_compute(t, g).as_dict()

    return P.U.ThreadWorld(WORLD).run(body)[0]


def test_all_lists_match():
    assert PFO.__all__ == JFO.__all__
    assert PK.__all__ == JK.__all__
    assert PK.KILL_POINTS == JK.KILL_POINTS
    assert PFO.STATES == JFO.STATES


def _boundary(P, tmp_path, rec=None):
    schedule = P.U.KillSchedule([P.U.KillSpec("drain-commit", at=1, rank=VICTIM)], world=WORLD)
    rejoin = threading.Barrier(WORLD)
    out, health = {}, {}

    def body(g):
        rg = P.res.ResilientGroup(P.U.KillGroup(g, schedule), timeout=20.0, retries=0,
                                  policy="quorum")
        t = _table(P, g.rank)
        sess = P.el.ElasticSession({"t": t}, str(tmp_path), process_group=rg, interval=10**9,
                                   fault_hook=schedule.fault_hook)
        domain = P.FO.FailureDomain({"t": t}, rg, session=sess, detect_after=2)
        try:
            for step in range(4):
                t.ingest(*_batch(P, step, g.rank))
            schedule.check("drain-commit", g.rank)
            domain.drain()
            sess.snapshot()
            schedule.check("drain-commit", g.rank)  # the victim dies here
            for _ in range(2):
                P.tk.sync_and_compute(t, rg)
            assert domain.poll() == (VICTIM,)
            loss = domain.recover()
            synced = domain.drain()
            survivor = synced["t"].compute().as_dict()
            assert synced["t"].sync_provenance.loss == loss
            if g.rank == 0 and P is PORT:
                from torcheval_tpu_torch.obs.server import healthz_payload

                with PFO._CURRENT_LOCK:
                    PFO._CURRENT = domain
                health[0] = healthz_payload()
            if g.rank == 0:
                schedule.revive(VICTIM)
        except P.U.InjectedCrash:
            schedule.revival.wait(30.0)
            rejoin.wait(30.0)
            domain.rejoin(dead_ranks=(VICTIM,))
            out[g.rank] = (None, None, domain.drain()["t"].compute().as_dict(), domain.loss)
            domain.close()
            return
        rejoin.wait(30.0)
        domain.rejoin()
        assert domain.state == "armed" and domain.survivors == tuple(range(WORLD))
        out[g.rank] = (loss, survivor, domain.drain()["t"].compute().as_dict(), domain.loss)
        domain.close()

    P.U.ThreadWorld(WORLD).run(body)
    return out, health


def test_boundary_kill_is_exact_and_rejoins_as_in_jax(tmp_path):
    from torcheval_tpu_torch import obs

    rec = obs.recorder()
    rec.reset()
    rec.enable()
    try:
        got, health = _boundary(PORT, tmp_path / "p")
        events = [e for e in rec.log.tail(0) if e.kind == "failover"]
    finally:
        rec.reset()
        rec.disable()
    want, _ = _boundary(JAX, tmp_path / "j")
    oracle = _fault_free(PORT, 4, 3)
    assert oracle == _fault_free(JAX, 4, 3)
    for rank in range(WORLD):
        loss, survivor, rejoined, kept = got[rank]
        jloss, jsurvivor, jrejoined, jkept = want[rank]
        assert tuple(kept) == tuple(jkept) and kept.exact
        assert rejoined == jrejoined == oracle
        if rank != VICTIM:
            assert tuple(loss) == tuple(jloss) == ((VICTIM,), 0, 0, 0)
            assert survivor == jsurvivor == oracle
    payload = health[0]
    assert payload["status"] == "degraded-world" and payload["healthy"] is True
    assert payload["failover"]["dead_ranks"] == [VICTIM]
    assert payload["failover"]["survivors"] == [0, 1, 3]
    assert payload["failover"]["loss"]["exact"] is True
    by_rank = {r: [e.action for e in events if e.rank == r] for r in range(WORLD)}
    for r in (0, 1, 3):
        assert by_rank[r] == ["detected", "reconstructed", "reformed", "rejoined"], by_rank
    assert by_rank[VICTIM] == ["rejoined"]


def _loss_case(P, tmp_path, *, snapshot_first, pool=None, steps_after=2):
    schedule = P.U.KillSchedule([P.U.KillSpec("drain-commit", at=1, rank=VICTIM)], world=WORLD)
    out = {}

    def body(g):
        rg = P.res.ResilientGroup(P.U.KillGroup(g, schedule), timeout=20.0, retries=0,
                                  policy="quorum")
        t = _table(P, g.rank)
        sess = P.el.ElasticSession({"t": t}, str(tmp_path), process_group=rg, interval=10**9,
                                   fault_hook=schedule.fault_hook)
        domain = P.FO.FailureDomain({"t": t}, rg, session=sess, detect_after=2)
        try:
            if snapshot_first:  # snapshot, then drain, then the kill
                for step in range(2):
                    t.ingest(*_batch(P, step, g.rank, pool=pool))
                sess.snapshot()
                schedule.check("drain-commit", g.rank)
                domain.drain()
            else:  # drain, snapshot, then steps the snapshot missed
                for step in range(2):
                    t.ingest(*_batch(P, step, g.rank))
                    sess.step_done()
                schedule.check("drain-commit", g.rank)
                domain.drain()
                sess.snapshot()
                for step in range(2, 2 + steps_after):
                    t.ingest(*_batch(P, step, g.rank))
                    sess.step_done()
            schedule.check("drain-commit", g.rank)
            for _ in range(2):
                P.tk.sync_and_compute(t, rg)
            assert domain.poll() == (VICTIM,)
            loss = domain.recover()
            out[g.rank] = (tuple(loss), domain.drain()["t"].compute().as_dict())
            domain.close()
        except P.U.InjectedCrash:
            return

    P.U.ThreadWorld(WORLD).run(body)
    return out


def test_nonboundary_kill_bounds_the_lost_steps_as_in_jax(tmp_path):
    got = _loss_case(PORT, tmp_path / "p", snapshot_first=False)
    want = _loss_case(JAX, tmp_path / "j", snapshot_first=False)
    oracle = _fault_free(PORT, 4, 2, skip={VICTIM: 2})
    assert sorted(got) == [0, 1, 3]
    for rank in got:
        assert got[rank][0] == want[rank][0] == ((VICTIM,), 2, 0, 0)
        assert got[rank][1] == want[rank][1] == oracle


def test_drain_after_snapshot_strips_the_dead_outbox_as_in_jax(tmp_path):
    from torcheval_tpu_torch.table._hash import hash_keys, owner_of

    pool = np.arange(200)
    pool = pool[owner_of(hash_keys(pool.astype(np.uint64)), WORLD) != VICTIM]
    got = _loss_case(PORT, tmp_path / "p", snapshot_first=True, pool=pool)
    want = _loss_case(JAX, tmp_path / "j", snapshot_first=True, pool=pool)
    oracle = _fault_free(PORT, 2, 2, pool=pool)
    for rank in got:
        assert got[rank][0] == want[rank][0] == ((VICTIM,), 0, 1, 0)
        assert got[rank][1] == want[rank][1] == oracle


@pytest.mark.parametrize("point", PK.KILL_POINTS)
def test_kill_point_matrix(tmp_path, point):
    """Every kill point, with a sync plane and a federation riding the
    domain: the survivors detect and recover, the federation's regions
    reform without the victim, and after the live rejoin every rank
    agrees and an elastic round trip at the full world is bitwise."""
    P = PORT
    schedule = PU.KillSchedule([PU.KillSpec(point, at=1, rank=VICTIM)], world=WORLD)
    rejoin = threading.Barrier(WORLD)
    bus = pfed.InProcessLinkBus()
    results, leaders = {}, {}

    def body(g):
        rg = pres.ResilientGroup(PU.KillGroup(g, schedule), timeout=20.0, retries=0,
                                 policy="quorum")
        t = _table(P, g.rank)
        sess = pel.ElasticSession({"t": t}, str(tmp_path), process_group=rg, interval=10**9,
                                  fault_hook=schedule.fault_hook)
        plane = pplane.SyncPlane({"mean": PM.Mean(device=CPU)}, rg, policy="quorum")
        fcoll = {"s": PM.Sum(device=CPU)}
        fed = pfed.Federation(rg, REGIONS_2X2, transport=bus, policy="quorum")
        domain = PFO.FailureDomain({"t": t}, rg, session=sess, plane=plane, federation=fed,
                                   detect_after=2)

        def serving_step(step):
            t.ingest(*_batch(P, step, g.rank, n=8))
            plane.metrics["mean"].update(torch.tensor([float(step + g.rank)]))
            plane.publish()
            schedule.check("plane-round", g.rank)
            try:
                plane.run_round()
            except Exception:  # noqa: BLE001 — the degraded round after a kill
                pass
            schedule.check("drain-commit", g.rank)
            domain.drain()
            fcoll["s"].update(torch.tensor([1.0]))
            schedule.check("federation-exchange", g.rank)
            try:
                fed.federate(fcoll)
            except Exception:  # noqa: BLE001 — the degraded exchange after a kill
                pass
            try:
                sess.snapshot()
            except Exception:  # noqa: BLE001 — the survivors' torn commit
                pass

        try:
            for step in range(2):
                serving_step(step)
            for _ in range(2):
                ptk.sync_and_compute(t, rg)
            assert domain.poll() == (VICTIM,)
            loss = domain.recover()
            assert domain.state == "recovered" and domain.survivors == (0, 1, 3)
            assert loss.ranks == (VICTIM,)
            # the eu region lost its leader: leadership moves to rank 3
            leaders[g.rank] = (fed.my_region.name, fed.is_leader, fed.my_region.ranks)
            domain.drain()
            if g.rank == 0:
                schedule.revive(VICTIM)
        except PU.InjectedCrash:
            schedule.revival.wait(30.0)
            rejoin.wait(30.0)
            domain.rejoin(dead_ranks=(VICTIM,))
        else:
            rejoin.wait(30.0)
            domain.rejoin()
        assert domain.state == "armed"
        vals = domain.drain()["t"].compute().as_dict()
        sess2 = pel.ElasticSession({"t": t}, str(tmp_path), process_group=rg, interval=10**9)
        sess2.snapshot()
        rejoin.wait(30.0)
        t2 = _table(P, g.rank)
        sess3 = pel.ElasticSession({"t": t2}, str(tmp_path), process_group=rg, interval=10**9)
        assert sess3.restore().world_size == WORLD
        assert ptk.sync_and_compute(t2, rg).as_dict() == vals
        results[g.rank] = vals
        domain.close()
        plane.close()
        fed.close()

    PU.ThreadWorld(WORLD).run(body)
    assert sorted(results) == list(range(WORLD))
    assert schedule.killed == [(point, 1, VICTIM)]
    assert all(results[r] == results[0] for r in range(WORLD))
    assert leaders[3] == ("eu", True, (3,)) and leaders[0] == ("us", True, (0, 1))


def test_poll_issues_no_collective_and_respects_detect_after():
    from torcheval_tpu_torch.distributed import ProcessGroup

    class Counting(ProcessGroup):
        def __init__(self, inner):
            self._inner, self.calls = inner, 0

        world_size = property(lambda self: self._inner.world_size)
        rank = property(lambda self: self._inner.rank)
        ranks = property(lambda self: self._inner.ranks)

        def new_subgroup(self, ranks):
            return self._inner.new_subgroup(ranks)

        def allgather_object(self, obj):
            self.calls += 1
            return self._inner.allgather_object(obj)

        def allgather_array(self, x):
            self.calls += 1
            return self._inner.allgather_array(x)

    schedule = PU.KillSchedule([PU.KillSpec("drain-commit", at=0, rank=VICTIM)], world=WORLD)
    states = {}

    def body(g):
        cg = Counting(g)
        rg = pres.ResilientGroup(PU.KillGroup(cg, schedule), timeout=20.0, retries=0,
                                 policy="quorum")
        t = _table(PORT, g.rank)
        domain = PFO.FailureDomain({"t": t}, rg, detect_after=3)
        try:
            t.ingest(*_batch(PORT, 0, g.rank))
            schedule.check("drain-commit", g.rank)
            seen = []
            for _ in range(3):
                base = cg.calls
                seen.append(domain.poll())
                assert cg.calls == base
                ptk.sync_and_compute(t, rg)
            seen.append(domain.poll())
            states[g.rank] = seen
            domain.close()
        except PU.InjectedCrash:
            return

    PU.ThreadWorld(WORLD).run(body)
    for seen in states.values():
        assert seen == [(), (), (), (VICTIM,)]


def test_note_failure_guard_and_counter_source():
    g = PU.ThreadWorld(1).views[0]
    t = _table(PORT, 0, world=1)
    domain = PFO.FailureDomain({"t": t}, g)
    try:
        with pytest.raises(RuntimeError, match="confirmed loss"):
            domain.recover()
        assert domain.note_failure((0,)) == ()
        from torcheval_tpu_torch.obs.counters import default_registry

        src = default_registry().read()["resilience"]
        assert src["armed"] == 1 and src["loss_exact"] == 1
        assert all(isinstance(v, (int, float)) for v in src.values())
    finally:
        domain.close()
    assert PFO.current_domain() is None


def _rescale(P):
    rejoin = threading.Barrier(WORLD)
    out = {}

    def body(g):
        ctrl = P.tab.AdmissionController(budget=P.tab.ServingBudget(max_keys=64, max_outbox=300))
        t = _table(P, g.rank, admission=ctrl)
        t.ingest(*_batch(P, 0, g.rank))
        domain = P.FO.FailureDomain({"t": t}, g)
        try:
            if g.rank != VICTIM:
                domain.note_failure((VICTIM,))
                domain.recover()
                shrunk = ctrl.budget.max_outbox
            rejoin.wait(30.0)
            domain.rejoin(dead_ranks=(VICTIM,))
            values = P.tk.sync_and_compute(t, g).as_dict()
            if g.rank != VICTIM:
                out[g.rank] = (shrunk, ctrl.budget.max_outbox, values)
        finally:
            domain.close()

    P.U.ThreadWorld(WORLD).run(body)
    return out


def test_admission_budget_rescales_to_the_survivors_and_back_as_in_jax():
    got, want = _rescale(PORT), _rescale(JAX)
    assert got == want
    for rank in (0, 1, 3):
        assert got[rank][0] == round(300 * (2 / 3) / (3 / 4)) and got[rank][1] == 300


def _spawned_rank(rank, path, out_dir):
    dist.init_process_group("gloo", store=dist.FileStore(path, 3), rank=rank, world_size=3)
    try:
        from torcheval_tpu_torch.distributed import MultiHostGroup, members_only

        g = MultiHostGroup()
        m = PM.Sum(device=CPU)
        m.update(torch.tensor([float(rank + 1)]))
        first = float(ptk.sync_and_compute(m, g))
        if rank == 2:
            return  # exits after one sync: the survivors must not need it
        with members_only():
            sub = g.new_subgroup([0, 1])
        second = float(ptk.sync_and_compute(m, sub))
        np.save(os.path.join(out_dir, f"r{rank}.npy"), np.array([first, second]))
    finally:
        if rank != 2:
            dist.destroy_process_group()


def test_survivor_group_forms_without_the_dead_process(tmp_path):
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    path = str(tmp_path / "store")
    procs = [ctx.Process(target=_spawned_rank, args=(r, path, str(tmp_path))) for r in range(3)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(120)
    assert [p.exitcode for p in procs] == [0, 0, 0]
    for r in (0, 1):
        assert np.load(tmp_path / f"r{r}.npy").tolist() == [6.0, 3.0]
