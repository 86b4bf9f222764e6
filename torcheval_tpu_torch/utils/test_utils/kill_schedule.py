# tev: scope=host
"""Seeded rank-kill chaos for :class:`torcheval_tpu_torch.failover.FailureDomain`.

:class:`FaultInjectionGroup` sabotages payloads on a live world;
:class:`SnapshotCrashPlan` kills one snapshot write. The failover crash
matrix needs the third fault shape: a whole RANK dying at a
scripted point of the serving loop — mid sync-plane round, mid drain
commit, mid federation exchange, mid snapshot shard write — and later
re-entering alive. Two pieces model it deterministically:

- :class:`KillSchedule` — the script. ``check(point, rank)`` is called by
  EVERY live rank at each scripted point of the loop (the elastic
  ``fault_hook`` adapter covers the snapshot point) and is a rendezvous:
  all live ranks arrive, the scripted victim is condemned under the lock,
  and only then is anyone released — so a kill is visible to every
  survivor strictly BEFORE any of them reaches the next collective. No
  wall-clock ordering, no cross-thread racing: a run replays identically.
- :class:`KillGroup` — the collective layer's view of the script. A dead
  member raises :class:`InjectedCrash` instead of communicating; the
  survivors detour the gather onto a cached survivors-only subgroup and
  raise :class:`~torcheval_tpu_torch.resilience.PartialGatherError` carrying
  the survivor payloads — the fault-aware-collective contract
  ``ResilientGroup`` escalation and ``FailureDomain`` detection consume.
  Neither side advances the full-world mailbox sequence, so a post-revive
  full-world gather (:meth:`FailureDomain.rejoin`) finds every rank's
  counters aligned — the property that makes LIVE rejoin possible.

Composes with :class:`ChaosLinkTransport` (link faults) and
``OverloadSchedule`` (traffic). Counterpart of
``torcheval_tpu/utils/test_utils/kill_schedule.py``.
"""

from __future__ import annotations

import threading
from typing import (
    Any,
    Dict,
    Iterable,
    List,
    NamedTuple,
    Sequence,
    Set,
    Tuple,
)

import numpy as np

from torcheval_tpu_torch.distributed import ProcessGroup
from torcheval_tpu_torch.resilience import PartialGatherError
from torcheval_tpu_torch.utils.test_utils.fault_injection import InjectedCrash

__all__ = [
    "KILL_POINTS",
    "KillGroup",
    "KillSchedule",
    "KillSpec",
]

# scripted points of the serving loop, in the order a steady-state step
# visits them (the failover crash matrix iterates this tuple)
KILL_POINTS: Tuple[str, ...] = (
    "plane-round",
    "drain-commit",
    "federation-exchange",
    "snapshot-shard",
)


class KillSpec(NamedTuple):
    """One scripted rank death.

    Args:
        point: one of :data:`KILL_POINTS`.
        at: 0-based GLOBAL visit index of that point (each full live-rank
            rendezvous on the point consumes one index).
        rank: the victim.
    """

    point: str
    at: int = 0
    rank: int = 0


class KillSchedule:
    """The deterministic kill/revive script for one test world.

    Args:
        specs: iterable of :class:`KillSpec` (plain tuples accepted).
        world: full world size — ``check`` rendezvous membership is
            every world rank not currently dead.
        timeout: seconds a rendezvous waits for stragglers before the
            harness declares the TEST (not the scenario) broken.

    ``died`` is set when any scripted kill fires; ``revival`` is the
    event a parked victim thread waits on before calling
    ``FailureDomain.rejoin`` (set by :meth:`revive`).
    """

    def __init__(
        self,
        specs: Iterable[KillSpec],
        *,
        world: int,
        timeout: float = 30.0,
    ) -> None:
        self.specs = [KillSpec(*s) for s in specs]
        for s in self.specs:
            if s.point not in KILL_POINTS:
                raise ValueError(
                    f"unknown kill point {s.point!r}; expected one of "
                    f"{KILL_POINTS}"
                )
            if not 0 <= int(s.rank) < int(world):
                raise ValueError(
                    f"kill rank {s.rank} outside world {world}"
                )
        self.world = int(world)
        self.timeout = float(timeout)
        self._cv = threading.Condition()
        self._dead: Set[int] = set()  # tev: guarded-by=_cv
        self._visits: Dict[str, int] = {}  # tev: guarded-by=_cv
        # (point, visit) -> ranks arrived at this rendezvous
        self._arrived: Dict[Tuple[str, int], Set[int]] = {}  # tev: guarded-by=_cv
        # (point, visit, rank) kill log; appended under _cv, read by
        # tests after the world joins
        self.killed: List[Tuple[str, int, int]] = []  # tev: guarded-by=_cv
        self.died = threading.Event()
        self.revival = threading.Event()

    # -------------------------------------------------------------- script

    def dead_ranks(self) -> Tuple[int, ...]:
        with self._cv:
            return tuple(sorted(self._dead))

    def is_dead(self, rank: int) -> bool:
        with self._cv:
            return int(rank) in self._dead

    def check(self, point: str, rank: int) -> None:
        """The scripted-point rendezvous (module docstring). Every LIVE
        rank calls this at the same loop position; raises
        :class:`InjectedCrash` on the scripted victim once all have
        arrived, returns on the survivors."""
        if point not in KILL_POINTS:
            raise ValueError(
                f"unknown kill point {point!r}; expected one of {KILL_POINTS}"
            )
        rank = int(rank)
        with self._cv:
            if rank in self._dead:
                raise InjectedCrash(
                    f"dead rank {rank} reached kill point {point!r}"
                )
            visit = self._visits.get(point, 0)
            slot = self._arrived.setdefault((point, visit), set())
            slot.add(rank)
            expected = set(range(self.world)) - self._dead
            if expected.issubset(slot):
                # last arrival closes the visit: condemn under the lock,
                # THEN release — survivors leave already knowing
                self._visits[point] = visit + 1
                for s in self.specs:
                    if (
                        s.point == point
                        and int(s.at) == visit
                        and int(s.rank) in expected
                    ):
                        self._dead.add(int(s.rank))
                        self.killed.append((point, visit, int(s.rank)))
                        self.died.set()
                del self._arrived[(point, visit)]
                self._cv.notify_all()
            else:
                ok = self._cv.wait_for(
                    lambda: self._visits.get(point, 0) > visit,
                    timeout=self.timeout,
                )
                if not ok:
                    raise RuntimeError(
                        f"kill rendezvous timed out at {point!r} visit "
                        f"{visit}: arrived "
                        f"{sorted(self._arrived.get((point, visit), ()))} "
                        f"of {sorted(expected)}"
                    )
            if rank in self._dead:
                raise InjectedCrash(
                    f"injected rank kill: rank {rank} at {point!r} "
                    f"visit {visit}"
                )

    def fault_hook(self, point: str, *, generation: int, rank: int) -> None:
        """``ElasticSession(fault_hook=...)`` adapter: the two-phase
        commit's ``mid-shard`` instant IS the ``snapshot-shard`` kill
        point (the shard file is half-written when the rank dies)."""
        del generation
        if point == "mid-shard":
            self.check("snapshot-shard", rank)

    def revive(self, rank: int) -> None:
        """Bring a killed rank back (the test's stand-in for the revived
        serving thread) and release every parked victim."""
        with self._cv:
            self._dead.discard(int(rank))
        self.revival.set()


class KillGroup(ProcessGroup):
    """Wrap ``inner`` so its collectives honor a :class:`KillSchedule`
    (module docstring: dead member crashes, survivors detour onto a
    cached survivors-only subgroup and raise ``PartialGatherError``,
    full-world sequence counters untouched on both sides)."""

    def __init__(self, inner: ProcessGroup, schedule: KillSchedule) -> None:
        self._inner = inner
        self.schedule = schedule
        self._subgroups: Dict[Tuple[int, ...], ProcessGroup] = {}

    # --------------------------------------------------------------- plumbing

    @property
    def world_size(self) -> int:
        return self._inner.world_size

    @property
    def rank(self) -> int:
        return self._inner.rank

    def unwrap(self) -> ProcessGroup:
        return self._inner.unwrap()

    @property
    def is_member(self) -> bool:
        return self._inner.is_member

    @property
    def ranks(self):
        return self._inner.ranks

    def new_subgroup(self, ranks: Sequence[int]) -> "KillGroup":
        """Subgroups stay under the schedule (a second kill while
        degraded must still be honored); a survivors-only subgroup with
        no dead members passes collectives straight through."""
        return KillGroup(self._inner.new_subgroup(ranks), self.schedule)

    # ------------------------------------------------------------ collectives

    def _gather(self, payload: Any, *, as_array: bool) -> List[Any]:
        members = tuple(self._inner.ranks)
        me = members[self._inner.rank]
        dead = tuple(
            r for r in self.schedule.dead_ranks() if r in members
        )
        if me in dead:
            raise InjectedCrash(
                f"dead rank {me} reached a collective on group {members}"
            )
        if not dead:
            if as_array:
                return self._inner.allgather_array(payload)
            return self._inner.allgather_object(payload)
        alive = tuple(r for r in members if r not in dead)
        sub = self._subgroups.get(alive)
        if sub is None:
            # every survivor constructs this detour subgroup at the same
            # lockstep call, so the mailbox tags line up; cached so
            # retries reuse one communicator (per-rank instance — no
            # cross-thread sharing)
            rel = tuple(members.index(r) for r in alive)
            sub = self._inner.new_subgroup(rel)
            self._subgroups[alive] = sub
        result = (
            sub.allgather_array(payload)
            if as_array
            else sub.allgather_object(payload)
        )
        raise PartialGatherError(
            f"injected rank kill: rank(s) {sorted(dead)} missing from "
            f"collective on group {members}",
            {members.index(r): v for r, v in zip(alive, result)},
        )

    def allgather_object(self, obj: Any) -> List[Any]:
        return self._gather(obj, as_array=False)

    def allgather_array(self, x: Any) -> List[np.ndarray]:
        return self._gather(np.asarray(x), as_array=True)
