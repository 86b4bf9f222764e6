"""Fault-tolerant metric sync: deadlines, retry/backoff, quorum degradation.

Counterpart of ``torcheval_tpu/resilience.py``, with the same public
names, defaults, messages and policy semantics. Without it one dead or
slow rank makes every collective of a ``sync_and_compute`` hang forever.

- :class:`ResilientGroup` decorates any ``ProcessGroup``
  (``MultiHostGroup``, ``LocalReplicaGroup``, ``ThreadRankGroup``, test
  fakes) with **per-collective deadlines** (the gather runs on a reusable
  per-caller-thread worker; the caller's wait is bounded), **retry with
  exponential backoff and deterministic jitter** for transient failures,
  and a **degradation policy**:

  - ``"raise"``: a bounded, typed :class:`SyncTimeoutError` instead of an
    unbounded hang;
  - ``"local"``: fall back to this rank's unsynced state, flagged stale in
    the sync provenance;
  - ``"quorum"``: merge the ranks that did respond, provided at least
    ``quorum`` (a fraction of world size) arrived.

- :class:`SyncHealth` counts attempts, retries, timeouts, corrupt
  payloads, degraded and full syncs, and re-formations.

- **Survivor re-formation**: with ``reform_after=N`` (or
  ``config.sync_reform_after()``), ``N`` consecutive quorum-degraded syncs
  missing the same ranks re-form the group onto a survivors-only subgroup
  (``new_subgroup``); later syncs run undegraded and their provenance says
  ``reformed=True``.

The happy path adds **zero** collectives: the wrapper forwards each gather
exactly once, and the partial-participation metadata rides the metadata
exchange ``synclib.sync_states`` already makes.

Partial gathers: a fault-aware inner group (tests:
``utils.test_utils.FaultInjectionGroup``) signals peer loss by raising
:class:`PartialGatherError` carrying the payloads of the ranks that did
respond. A plain timeout yields no partial data: the surviving set is then
this rank alone.

What the worker thread carries is host data only: ``synclib`` packs every
state to numpy on the caller's thread before a gather, so no CUDA tensor
is copied on the worker's stream.

A deadline cannot abort a collective in flight (gloo cannot cancel one):
the timed-out attempt stays blocked on its worker until it lands or the
backend's own timeout fires. The worker is then abandoned, its late
completion is harvested instead of reissuing the collective, and the next
collective on the caller's thread is fenced until the straggler is done,
so every rank keeps issuing collectives in the same order.

Observability (``torcheval_tpu_torch.obs``), each one attribute read when
off: with the recorder on, every lifecycle step (retry cause,
degradation, re-formation) is a ``RetryEvent`` and a collective runs in a
``torcheval.collective`` span feeding the ``collective`` latency digest;
with the flight recorder on, a collective is ONE ``FlightRecord`` on the
caller's ring, opened on the caller's thread and issued per attempt,
while the deadline worker runs the inner gather with recording
suppressed, as in the JAX module.
"""

from __future__ import annotations

import math
import queue
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

from torcheval_tpu_torch.distributed import LocalReplicaGroup, ProcessGroup, _as_numpy
from torcheval_tpu_torch.obs import flight as _flight
from torcheval_tpu_torch.obs import hist as _obs_hist
from torcheval_tpu_torch.obs.events import RetryEvent
from torcheval_tpu_torch.obs.flight import FLIGHT as _FLIGHT
from torcheval_tpu_torch.obs.recorder import RECORDER as _OBS

__all__ = [
    "PartialGatherError",
    "ResilientGroup",
    "SyncHealth",
    "SyncIntegrityError",
    "SyncProvenance",
    "SyncTimeoutError",
    "TransientSyncError",
    "backoff_delay",
    "bounded_call",
    "default_sync_health",
]

# A degrading policy is a promise that a dead host costs a bounded wait:
# without a deadline a plain (non-fault-aware) group would still hang
# forever, so groups constructed with policy != "raise" and no explicit
# timeout get this default deadline per collective.
DEFAULT_DEGRADING_TIMEOUT = 300.0

# Health of every config-driven (auto-wrapped) sync: those wrappers are
# constructed per toolkit call, so their counters would be unreachable and
# reset every sync without a process-wide record to accumulate into.
_DEFAULT_HEALTH = None  # tev: guarded-by=_DEFAULT_HEALTH_LOCK
_DEFAULT_HEALTH_LOCK = threading.Lock()


def default_sync_health() -> "SyncHealth":
    """The process-wide :class:`SyncHealth` accumulated by every
    config-driven sync (toolkit calls under ``config.sync_resilience`` /
    env knobs / ``on_failure=``, where the caller never holds the group
    object). Explicitly constructed ``ResilientGroup``s keep their own."""
    global _DEFAULT_HEALTH
    with _DEFAULT_HEALTH_LOCK:
        if _DEFAULT_HEALTH is None:
            _DEFAULT_HEALTH = SyncHealth()
        return _DEFAULT_HEALTH


class SyncTimeoutError(RuntimeError):
    """A metric-sync collective missed its deadline (or lost too many peers
    to satisfy the degradation policy) after all retries."""


class TransientSyncError(RuntimeError):
    """A retryable wire glitch (the inner group believes the next attempt
    may succeed). ``ResilientGroup`` retries these with backoff."""


class SyncIntegrityError(RuntimeError):
    """A gathered payload failed its checksum (rides the metadata exchange
    — see ``synclib.sync_states``). Raised under the ``raise`` policy;
    degrading policies drop the corrupt rank instead."""


class PartialGatherError(RuntimeError):
    """A fault-aware collective completed for only a subset of ranks.

    ``values`` maps rank -> that rank's payload for every rank that DID
    respond. ``ResilientGroup`` turns this into a quorum merge (policy
    ``"quorum"``), a local fallback (``"local"``), or a
    :class:`SyncTimeoutError` (``"raise"``).

    CONTRACT for inner groups raising this: every surviving rank must be
    told the SAME survivor set (fault-tolerant collective stacks provide
    this via consensus-based membership — PCCL, arxiv 2505.14065 §3).
    Divergent per-rank survivor sets would make ranks pad the follow-up
    payload gather to different static shapes and merge different state
    (split-brain); this layer consumes the membership decision, it does
    not arbitrate one.
    """

    def __init__(self, message: str, values: Dict[int, Any]) -> None:
        super().__init__(message)
        self.values = dict(values)


class SyncProvenance(NamedTuple):
    """Which ranks contributed to a synced result (attached to metrics
    returned by ``toolkit.get_synced_metric(_collection)`` as
    ``metric.sync_provenance``).

    The fields and defaults are the JAX package's. A blocking sync writes
    ``ranks``, ``world_size``, ``degraded``, ``policy`` and ``reformed``;
    the others stay at their defaults in this package until the modules
    that write them are ported: the staleness triple (``version``,
    ``rounds_behind``, ``wall_age_seconds``) comes from a sync plane, the
    admission triple (``sampled_fraction``, ``admission_rung``,
    ``admission_epoch``) from an armed metric table, ``wire_tier`` from
    the lossy wire rungs and ``loss`` from a failure domain's recovery.
    """

    ranks: Tuple[int, ...]
    world_size: int
    degraded: bool  # True when ranks != all of world (result may be stale)
    policy: str
    # True once the group has re-formed onto a survivors-only subgroup
    # (persistent-failure escalation): ranks/world_size are then relative
    # to the REFORMED subgroup -- map to global ranks via ``group.ranks``.
    reformed: bool = False
    version: int = 0  # plane merge version this read observed (0 = blocking)
    rounds_behind: int = 0  # publish generations newer than this version
    wall_age_seconds: float = 0.0  # age of the merged snapshot at read time
    sampled_fraction: float = 1.0  # Bernoulli keep probability at this rung
    admission_rung: int = 0  # 0=full 1=sampled 2=priority-shed
    admission_epoch: int = 0  # drain epoch the rung last changed
    # the lossiest wire encoding any surviving rank applied: "exact" |
    # "bf16" | "int8" (only "exact" exists here so far)
    wire_tier: str = "exact"
    # None, or the bound of what a rank-loss recovery could not rebuild
    loss: Any = None


@dataclass
class SyncHealth:
    """Running observability record for one ``ResilientGroup``.

    Counters accumulate over the group's lifetime; ``participating_ranks``
    and ``last_good_sync`` reflect the most recent sync. Read it off
    ``group.health`` when deciding whether degraded metrics are
    trustworthy.
    """

    attempts: int = 0  # tev: guarded-by=_lock
    retries: int = 0  # tev: guarded-by=_lock
    timeouts: int = 0  # tev: guarded-by=_lock
    transient_errors: int = 0  # tev: guarded-by=_lock
    partial_gathers: int = 0  # tev: guarded-by=_lock
    corrupt_payloads: int = 0  # tev: guarded-by=_lock
    degraded_syncs: int = 0  # tev: guarded-by=_lock
    full_syncs: int = 0  # tev: guarded-by=_lock
    last_good_sync: Optional[float] = None  # tev: guarded-by=_lock
    participating_ranks: Tuple[int, ...] = ()  # tev: guarded-by=_lock
    world_size: int = 0
    policy: str = "raise"
    # survivor re-formation (persistent-failure escalation)
    reforms: int = 0  # tev: guarded-by=_lock
    reformed_to: Tuple[int, ...] = ()  # tev: guarded-by=_lock
    consecutive_missing: Tuple[int, ...] = ()  # tev: guarded-by=_lock
    consecutive_missing_count: int = 0  # tev: guarded-by=_lock
    _lock: threading.Lock = field(
        default_factory=threading.Lock, repr=False, compare=False
    )

    def as_dict(self) -> Dict[str, Any]:
        # one consistent snapshot: never a bumped `attempts` next to a
        # not-yet-bumped `timeouts` mid-update
        with self._lock:
            return {
                "attempts": self.attempts,
                "retries": self.retries,
                "timeouts": self.timeouts,
                "transient_errors": self.transient_errors,
                "partial_gathers": self.partial_gathers,
                "corrupt_payloads": self.corrupt_payloads,
                "degraded_syncs": self.degraded_syncs,
                "full_syncs": self.full_syncs,
                "last_good_sync": self.last_good_sync,
                "participating_ranks": list(self.participating_ranks),
                "world_size": self.world_size,
                "policy": self.policy,
                "reforms": self.reforms,
                "reformed_to": list(self.reformed_to),
                "consecutive_missing": list(self.consecutive_missing),
                "consecutive_missing_count": self.consecutive_missing_count,
            }


class _SyncWorker:
    """One reusable DAEMON worker thread running collective attempts.

    Deliberately not ``concurrent.futures``: its pools register an atexit
    join of every (non-daemon) worker, so a thread still blocked inside a
    dead host's collective would hang interpreter exit — re-creating at
    shutdown exactly the hang the deadline exists to prevent. A daemon
    loop thread dies with the process, and reusing it keeps the happy-path
    cost to one queue hop (~tens of µs).
    """

    def __init__(self) -> None:
        self._jobs: "queue.SimpleQueue" = queue.SimpleQueue()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="torcheval-sync"
        )
        self._thread.start()

    def _loop(self) -> None:  # tev: scope=worker
        while True:
            job = self._jobs.get()
            if job is None:  # stop sentinel: surplus reclaimed worker
                return
            fn, box, done = job
            try:
                box["value"] = fn()
            except BaseException as e:  # noqa: BLE001 — ferried to caller
                box["error"] = e
            done.set()

    def stop(self) -> None:
        self._jobs.put(None)

    def submit(
        self, fn: Callable[[], Any]
    ) -> Tuple[Dict[str, Any], threading.Event]:
        box: Dict[str, Any] = {}
        done = threading.Event()
        self._jobs.put((fn, box, done))
        return box, done


def _harvest(box: Dict[str, Any]) -> Any:
    if "error" in box:
        raise box["error"]
    return box["value"]


# ONE worker per CALLER THREAD, shared by every ResilientGroup that thread
# drives: the sync path is caller-serial PER THREAD, and a per-group worker
# would leak one never-exiting daemon thread per auto-wrapped toolkit call
# (config-driven wrapping constructs a fresh group per sync). Thread-local,
# not process-global: concurrent caller threads (a multi-threaded eval
# loop, ThreadWorld rank emulation) are independent collective sequences
# — serializing them through one worker would deadlock rendezvousing
# collectives, and one thread's straggler must not fence another thread's
# healthy sync. A timed-out worker is poisoned for its thread — its thread
# is stuck inside the abandoned collective — and the next call creates a
# replacement.
_TLS = threading.local()


class _WorkerBox(list):
    """1-slot box holding a caller thread's idle reusable worker.

    When the caller thread dies, its thread-local storage is released and
    this box is garbage-collected: stop the idle worker then, so each
    exiting caller thread does not leave a permanently-parked
    'torcheval-sync' daemon behind.
    """

    def __del__(self) -> None:
        worker = self[0] if self else None
        if worker is not None:
            try:
                worker.stop()
            except Exception:  # noqa: BLE001 — interpreter teardown
                pass


class _InFlightList(list):
    """A caller thread's abandoned (done event, worker) attempts.

    On the caller thread's exit this list is GC'd: enqueue each worker's
    stop sentinel so a straggler whose collective eventually LANDS drains
    the sentinel next and exits, instead of parking in ``_jobs.get()``
    forever (the process-global design reclaimed these from any thread;
    thread-local state must reclaim them at teardown). A worker stuck in
    a never-returning collective stays stuck — unreclaimable by
    construction, it dies with the process, same as before.
    """

    def __del__(self) -> None:
        for _done, worker in self:
            try:
                worker.stop()
            except Exception:  # noqa: BLE001 — interpreter teardown
                pass


def _tls_state() -> Tuple[List[Optional[_SyncWorker]], list]:
    """This caller thread's (shared-worker box, in-flight list)."""
    if not hasattr(_TLS, "worker_box"):
        _TLS.worker_box = _WorkerBox([None])
        # abandoned attempts still in flight — PER-THREAD but surviving
        # group objects (config-driven wrapping constructs a fresh
        # ResilientGroup per sync), so it cannot live on the group
        _TLS.in_flight = _InFlightList()
    return _TLS.worker_box, _TLS.in_flight


def _reclaim_finished() -> None:
    """Recycle workers whose abandoned attempt has since completed: one is
    reinstated as the shared worker, surplus ones are stopped — a
    deadline miss whose collective lands late must not leak a thread."""
    box, in_flight = _tls_state()
    pending = []
    for done, worker in in_flight:
        if not done.is_set():
            pending.append((done, worker))
        elif box[0] is None:
            box[0] = worker  # idle again: back to work
        else:
            worker.stop()
    in_flight[:] = pending


def _get_worker() -> _SyncWorker:
    _reclaim_finished()
    box, _ = _tls_state()
    if box[0] is None:
        box[0] = _SyncWorker()
    return box[0]


def _poison_worker(worker: _SyncWorker, done: threading.Event) -> None:
    box, in_flight = _tls_state()
    if box[0] is worker:
        box[0] = None
    in_flight.append((done, worker))


def _still_in_flight(budget: float) -> bool:
    """True when any abandoned collective of THIS caller thread is STILL
    running after waiting up to ``budget`` seconds for the stragglers to
    land."""
    deadline = time.monotonic() + max(budget, 0.0)
    _reclaim_finished()
    _, in_flight = _tls_state()
    pending = [done for done, _ in in_flight]
    stuck = False
    for done in pending:
        if not done.wait(max(deadline - time.monotonic(), 0.0)):
            stuck = True
            break
    _reclaim_finished()
    return stuck


def backoff_delay(
    attempt: int,
    *,
    base: float = 0.05,
    maximum: float = 2.0,
    jitter: float = 0.5,
    rng: Optional[random.Random] = None,
) -> float:
    """The ONE exponential-backoff law of the resilience stack:
    ``min(base * 2**(attempt-1), maximum) * (1 + jitter * u)`` with ``u``
    from ``rng`` (deterministic for a seeded ``random.Random``; 0 when
    ``rng`` is None or ``jitter`` is 0): the JAX package's delays, draw
    for draw. Used by :class:`ResilientGroup` retries."""
    delay = min(base * (2 ** max(attempt - 1, 0)), maximum)
    if jitter and rng is not None:
        delay *= 1.0 + jitter * rng.random()
    return delay


def bounded_call(fn: Callable[[], Any], timeout: Optional[float]) -> Any:
    """Run ``fn()`` under the resilience deadline machinery: the
    per-caller-thread reusable daemon worker (:class:`_SyncWorker`), a
    bounded wait, and worker poisoning on a miss — so a wedged blocking
    call (a coordination-service RPC, a stuck collective probe) costs a
    bounded wait instead of hanging the caller. Raises
    :class:`SyncTimeoutError` on a miss; ``timeout=None`` runs inline.

    This is the standalone form of :meth:`ResilientGroup._bounded` for
    callers that are not a collective sequence; it does NOT interact with
    the in-flight collective fence.
    """
    if timeout is None:
        return fn()
    worker = _get_worker()
    box, done = worker.submit(fn)
    if done.wait(timeout):
        return _harvest(box)
    _poison_worker(worker, done)
    raise SyncTimeoutError(f"bounded call missed its {timeout}s deadline")


def quorum_count(fraction: float, world: int) -> int:
    """Minimum surviving-rank count for a quorum ``fraction`` of ``world``
    — the single definition shared by the per-collective check
    (``ResilientGroup``) and the post-integrity-intersection check
    (``synclib._assemble``)."""
    return max(1, math.ceil(fraction * world))


class ResilientGroup(ProcessGroup):
    """Decorate any ``ProcessGroup`` with deadlines, retries, and graceful
    degradation. See the module docstring for the policy semantics.

    Args:
        inner: the group to wrap (``MultiHostGroup``, ``LocalReplicaGroup``,
            ``ThreadRankGroup``, a test fake, or a ``FaultInjectionGroup``).
        timeout: per-collective deadline in seconds; ``None`` (default from
            ``config.sync_timeout()``) waits forever: the collective runs
            inline with no worker thread.
        retries: extra attempts after the first, for transient failures /
            timeouts (default from ``config.sync_retries()``).
        policy: ``"raise"`` | ``"local"`` | ``"quorum"`` (default from
            ``config.sync_degradation()``).
        quorum: minimum participating fraction of world size for the
            ``"quorum"`` policy (default from ``config.sync_quorum()``).
        backoff_base / backoff_max / backoff_jitter / seed: exponential
            backoff schedule ``min(base * 2**k, max) * (1 + jitter * u)``
            with ``u`` drawn from a ``random.Random(seed)``: deterministic
            for a given seed and call sequence.
        reform_after: persistent-failure escalation threshold (default
            from ``config.sync_reform_after()``, 0 = disabled): after this
            many consecutive quorum-degraded syncs missing the same ranks
            the group re-forms onto a survivors-only subgroup
            (``inner.new_subgroup``), so later syncs run undegraded. Only
            meaningful under ``policy="quorum"`` and a long-lived group
            object: the streak lives here, not in config state.
        health: share an existing :class:`SyncHealth` (used by
            :meth:`with_policy`); a fresh one is created by default.

    Examples::

        >>> from torcheval_tpu_torch.distributed import default_process_group
        >>> from torcheval_tpu_torch.resilience import ResilientGroup
        >>> group = ResilientGroup(
        ...     default_process_group(), timeout=30.0, policy="quorum"
        ... )
        >>> # value = sync_and_compute(metric, group)  # survives a dead host
        >>> group.health.timeouts
        0
    """

    def __init__(
        self,
        inner: ProcessGroup,
        *,
        timeout: Optional[float] = None,
        retries: Optional[int] = None,
        policy: Optional[str] = None,
        quorum: Optional[float] = None,
        backoff_base: float = 0.05,
        backoff_max: float = 2.0,
        backoff_jitter: float = 0.5,
        seed: int = 0,
        reform_after: Optional[int] = None,
        health: Optional[SyncHealth] = None,
    ) -> None:
        from torcheval_tpu_torch import config

        self._inner = inner
        # the group collectives actually run on: ``inner`` until a
        # persistent-failure escalation re-forms onto a survivors-only
        # subgroup of it (see ``note_sync_result``)
        self._active: ProcessGroup = inner
        self.reform_after = (
            config.sync_reform_after() if reform_after is None else int(reform_after)
        )
        if self.reform_after < 0:
            raise ValueError(
                f"reform_after must be >= 0 (0 disables), got {reform_after}"
            )
        self.reform_count = 0
        self._missing_streak: Tuple[int, ...] = ()
        self._streak = 0
        self.timeout = (
            config.sync_timeout() if timeout is None else config._check_timeout(timeout)
        )
        self.retries = config.sync_retries() if retries is None else int(retries)
        policy = config.sync_degradation() if policy is None else policy
        self.policy = config.check_sync_policy(policy)
        if self.policy != "raise" and self.timeout is None:
            # a degrading policy without a deadline would still hang
            # forever on a plain group (degradation only fires on timeout
            # / transient / partial signals): arm the default deadline
            self.timeout = DEFAULT_DEGRADING_TIMEOUT
        self.quorum = config.sync_quorum() if quorum is None else float(quorum)
        if not 0.0 < self.quorum <= 1.0:
            raise ValueError(f"quorum must be a fraction in (0, 1], got {self.quorum}")
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self.backoff_jitter = backoff_jitter
        self.seed = seed
        self._rng = random.Random(seed)
        # (box, done) of a timed-out attempt still in flight on its worker
        self._late: Optional[Tuple[Dict[str, Any], threading.Event]] = None
        self._local_mode = isinstance(inner.unwrap(), LocalReplicaGroup)
        if health is None:
            health = SyncHealth()
            health.policy = self.policy  # shared health keeps its creator's
        self.health = health
        self.health.world_size = self.world_size

    # --------------------------------------------------------------- plumbing

    @property
    def world_size(self) -> int:
        return self._active.world_size

    @property
    def rank(self) -> int:
        return self._active.rank

    def unwrap(self) -> ProcessGroup:
        return self._active.unwrap()

    @property
    def is_member(self) -> bool:
        return self._active.is_member

    @property
    def ranks(self):
        return self._active.ranks

    def _sibling(self, inner: ProcessGroup, policy: str) -> "ResilientGroup":
        return ResilientGroup(
            inner,
            timeout=self.timeout,
            retries=self.retries,
            policy=policy,
            quorum=self.quorum,
            backoff_base=self.backoff_base,
            backoff_max=self.backoff_max,
            backoff_jitter=self.backoff_jitter,
            seed=self.seed,
            reform_after=self.reform_after,
            health=self.health,
        )

    def new_subgroup(self, ranks) -> "ResilientGroup":
        """Subgroup scoping composes with resilience: the active group's
        subgroup (ranks relative to the group the caller sees: the
        reformed subgroup after an escalation), wrapped with this group's
        knobs and the same shared :class:`SyncHealth` (quorum fractions
        then apply to the subgroup's world size)."""
        return self._sibling(self._active.new_subgroup(ranks), self.policy)

    @property
    def degradation_policy(self) -> str:
        """Read by ``synclib.sync_states`` to decide whether a corrupt or
        missing rank is droppable or fatal."""
        return self.policy

    @property
    def quorum_fraction(self) -> float:
        return self.quorum

    def with_policy(self, policy: str) -> "ResilientGroup":
        """A sibling wrapper around the same inner group and the same
        :class:`SyncHealth`, differing only in degradation policy (used by
        the toolkit's per-call ``on_failure=`` override). The sibling
        inherits this group's re-formation state (active subgroup,
        escalation streak), but its own future escalations do not write
        back: reuse the original group for a durable escalation record."""
        if policy == self.policy:
            return self
        sibling = self._sibling(self._inner, policy)
        sibling._active = self._active
        sibling._local_mode = self._local_mode
        sibling.reform_count = self.reform_count
        sibling._missing_streak = self._missing_streak
        sibling._streak = self._streak
        return sibling

    # ------------------------------------------------------------- observers

    def note_corrupt(self, rank: int) -> None:
        """Called by ``synclib`` when rank's payload fails its checksum."""
        with self.health._lock:
            self.health.corrupt_payloads += 1

    def note_sync_result(self, ranks: List[int], world: int) -> None:
        """Called by ``synclib`` with the final surviving-rank set of one
        whole state sync (after cross-collective intersection). Drives the
        persistent-failure escalation: ``reform_after`` consecutive
        degraded syncs missing the same ranks re-form this group onto the
        survivors (``_reform``), effective from the next sync."""
        alive = set(ranks)
        missing = tuple(r for r in range(world) if r not in alive)
        if not missing:
            self._missing_streak, self._streak = (), 0
        elif missing == self._missing_streak:
            self._streak += 1
        else:
            self._missing_streak, self._streak = missing, 1
        with self.health._lock:
            self.health.participating_ranks = tuple(ranks)
            self.health.consecutive_missing = self._missing_streak
            self.health.consecutive_missing_count = self._streak
            if len(ranks) == world:
                self.health.full_syncs += 1
                self.health.last_good_sync = time.monotonic()
            else:
                self.health.degraded_syncs += 1
        if (
            self.reform_after
            and self.policy == "quorum"
            and missing
            and self._streak >= self.reform_after
        ):
            self._reform(list(ranks))

    @property
    def was_reformed(self) -> bool:
        """True once this group escalated onto a survivors-only subgroup
        (stamped into every subsequent :class:`SyncProvenance`)."""
        return self.reform_count > 0

    def _reform(self, survivors: List[int]) -> None:
        """Escalate onto a survivors-only subgroup of the active group.

        ``survivors`` are active-group-relative ranks. Later collectives
        run on the subgroup, undegraded, and provenance and quorum become
        subgroup-relative. Dead ranks that come back must rebuild their
        own group (e.g. through an ``elastic.ElasticSession`` resume). By
        the ``PartialGatherError`` contract every survivor observed the
        same survivor set for ``reform_after`` consecutive syncs, so every
        survivor re-forms the same subgroup at the same sync index."""
        try:
            sub = self._active.new_subgroup(sorted(survivors))
        except NotImplementedError:
            # the inner group cannot scope to a subset (a bare test
            # fake): keep degrading per sync rather than failing the sync
            self._missing_streak, self._streak = (), 0
            return
        self._active = sub
        self._local_mode = isinstance(sub.unwrap(), LocalReplicaGroup)
        self.reform_count += 1
        self._note_event("reform", detail=f"survivors {sorted(survivors)}")
        self._missing_streak, self._streak = (), 0
        with self.health._lock:
            self.health.reforms += 1
            self.health.reformed_to = tuple(sub.ranks)
            self.health.world_size = sub.world_size
            self.health.consecutive_missing = ()
            self.health.consecutive_missing_count = 0

    # ------------------------------------------------------------- observers

    def _note_event(self, reason: str, attempt: int = 0, detail: str = "") -> None:
        """Record one resilience lifecycle event (retry cause, degradation
        outcome, re-formation) when the observability recorder is on: the
        event-stream twin of the :class:`SyncHealth` counters. One
        attribute read when off. Timeout/failure events carry the
        flight-ring tail when the flight recorder is on: *which*
        collective in the sequence stalled."""
        if _OBS.enabled:
            flight_tail = ""
            if _FLIGHT.enabled and reason in ("timeout", "failed"):
                flight_tail = _FLIGHT.tail_text()
            _OBS.record(
                RetryEvent(
                    rank=self.rank,
                    reason=reason,
                    attempt=attempt,
                    policy=self.policy,
                    detail=detail,
                    flight=flight_tail,
                )
            )

    # -------------------------------------------------------------- deadline

    def _bounded(self, fn: Callable[[], Any]) -> Any:
        """Run one collective attempt under the deadline on the reusable
        daemon worker (see :class:`_SyncWorker`). On timeout the worker is
        abandoned, still blocked inside the collective, and the in-flight
        attempt is stashed on ``self._late`` so the retry loop waits for
        its late completion instead of reissuing (reissuing while the
        first is still running would desynchronize the rank-wide
        collective order)."""
        if self.timeout is None:
            return fn()
        worker = _get_worker()
        box, done = worker.submit(fn)
        if done.wait(self.timeout):
            return _harvest(box)
        self._late = (box, done)
        _poison_worker(worker, done)  # its thread is stuck in `fn`
        raise SyncTimeoutError(
            f"metric sync collective missed its {self.timeout}s deadline"
        )

    def _next_backoff(self, attempt: int) -> float:
        """Deterministic exponential backoff with jitter for retry
        ``attempt`` (1-based): the shared :func:`backoff_delay` law."""
        return backoff_delay(
            attempt,
            base=self.backoff_base,
            maximum=self.backoff_max,
            jitter=self.backoff_jitter,
            rng=self._rng,
        )

    # ------------------------------------------------------------ collectives

    def _resilient(
        self,
        fn: Callable[[], List[Any]],
        local_only: Callable[[], Tuple[List[Any], List[int]]],
        op: str = "collective",
        nbytes: int = 0,
    ) -> Tuple[List[Any], List[int]]:
        """Observability shell around :meth:`_resilient_impl`: with the
        recorder on, the whole collective (every attempt and the
        degradation decision) runs inside ONE ``torcheval.collective``
        span, which the ``RetryEvent``\\ s underneath parent to, and its
        wall time feeds the ``collective`` latency digest. With the flight
        recorder on, the whole collective is ONE flight record — enqueued
        here on the caller's thread, issued per attempt, completed/failed
        with the surviving ranks — visible mid-flight to the stall
        watchdog; a raised :class:`SyncTimeoutError` carries the ring tail
        as ``e.flight_tail``. Both off: one attribute read each."""
        record = None
        if _FLIGHT.enabled:
            record = _FLIGHT.start(
                op, payload_bytes=nbytes, rank=self.rank,
                world_size=self.world_size, state="enqueued",
            )
            if record is not None:
                inner = fn
                # the inner gather may run on the deadline WORKER thread,
                # whose own thread-local depth guard cannot see this
                # record: suppress explicitly so a wrapped plain group does
                # not record the same logical collective twice
                fn = lambda: _flight.suppressed(inner)  # noqa: E731
        try:
            if not _OBS.enabled:
                result = self._resilient_impl(fn, local_only, record)
            else:
                t0 = time.monotonic()
                try:
                    with _OBS.span("torcheval.collective"):
                        result = self._resilient_impl(fn, local_only, record)
                finally:
                    _obs_hist.observe("collective", time.monotonic() - t0)
        except BaseException as e:  # noqa: BLE001 — recorded, re-raised
            _FLIGHT.fail(record, f"{type(e).__name__}: {e}")
            if record is not None and isinstance(e, SyncTimeoutError):
                e.flight_tail = _FLIGHT.tail_text()
            raise
        values, ranks = result
        _FLIGHT.complete(
            record,
            ranks=tuple(ranks),
            detail=(
                "" if len(ranks) == self.world_size
                else f"degraded to ranks {list(ranks)}"
            ),
        )
        return result

    def _resilient_impl(
        self,
        fn: Callable[[], List[Any]],
        local_only: Callable[[], Tuple[List[Any], List[int]]],
        flight_record=None,
    ) -> Tuple[List[Any], List[int]]:
        """Run one collective with retries, then apply the degradation
        policy. Returns ``(payloads, participating_ranks)``, rank-aligned
        and ascending.

        A timed-out attempt is never reissued while still in flight: the
        original collective may still complete, and a second issue would
        pair off-by-one with the peers' collective sequence forever after.
        Retries after a timeout instead extend the wait on the original
        (backoff plus one more deadline); only transient wire errors,
        where the attempt definitely failed, reissue the collective.
        """
        h = self.health
        world = self.world_size
        partial: Optional[Dict[int, Any]] = None
        # FENCE: a previously abandoned collective of this caller thread
        # must complete (late) before a new one is issued, or this rank's
        # collective sequence pairs off-by-one with its peers' forever
        # after. While one is still running, this collective degrades
        # without issuing.
        self._late = None
        if _still_in_flight(self.timeout or 0.0):
            with h._lock:
                h.attempts += 1
                h.timeouts += 1
            self._note_event("timeout", detail="abandoned collective still in flight")
            return self._degrade(None, local_only)
        for attempt in range(self.retries + 1):
            delay = 0.0
            if attempt:
                with h._lock:
                    h.retries += 1
                delay = self._next_backoff(attempt)
            with h._lock:
                h.attempts += 1
            try:
                if self._late is not None:
                    # wait out the in-flight original instead of reissuing
                    box, done = self._late
                    if not done.wait(delay + (self.timeout or 0.0)):
                        with h._lock:
                            h.timeouts += 1
                        self._note_event("timeout", attempt, "late original still running")
                        continue
                    self._late = None
                    result = _harvest(box)
                else:
                    if delay:
                        time.sleep(delay)
                    _FLIGHT.issued(flight_record)
                    result = self._bounded(fn)
            except PartialGatherError as e:
                with h._lock:
                    h.partial_gathers += 1
                self._note_event("partial-gather", attempt, f"ranks {sorted(e.values)}")
                partial = dict(e.values)
                # peer loss is not transient: a quorum of survivors is
                # usable at once, without burning the retry budget
                if self.policy == "quorum" and len(
                    self._with_own(partial, local_only)
                ) >= self._quorum_count():
                    break
                continue
            except TransientSyncError:
                with h._lock:
                    h.transient_errors += 1
                self._note_event("transient", attempt)
                continue
            except SyncTimeoutError:
                with h._lock:
                    h.timeouts += 1
                self._note_event("timeout", attempt)
                continue
            return list(result), list(range(world))
        return self._degrade(partial, local_only)

    def _quorum_count(self) -> int:
        return quorum_count(self.quorum, self.world_size)

    def _with_own(
        self,
        partial: Optional[Dict[int, Any]],
        local_only: Callable[[], Tuple[List[Any], List[int]]],
    ) -> Dict[int, Any]:
        """Survivor map: whatever arrived, plus this rank's own payload
        (always available without any wire traffic)."""
        survivors = dict(partial or {})
        own_vals, own_ranks = local_only()
        for r, v in zip(own_ranks, own_vals):
            survivors.setdefault(r, v)
        return survivors

    def _degrade(
        self,
        partial: Optional[Dict[int, Any]],
        local_only: Callable[[], Tuple[List[Any], List[int]]],
    ) -> Tuple[List[Any], List[int]]:
        h = self.health
        if self.policy == "local":
            vals, ranks = local_only()
            self._note_event("degraded-local", detail=f"ranks {list(ranks)}")
            return list(vals), list(ranks)
        if self.policy == "quorum":
            survivors = self._with_own(partial, local_only)
            ranks = sorted(survivors)
            if len(ranks) >= self._quorum_count():
                self._note_event("degraded-quorum", detail=f"ranks {ranks}")
                return [survivors[r] for r in ranks], ranks
            self._note_event(
                "failed",
                detail=f"quorum not met: {len(ranks)}/{self.world_size}",
            )
            raise SyncTimeoutError(
                f"metric sync quorum not met: {len(ranks)}/{self.world_size} "
                f"ranks responded, quorum requires >= {self._quorum_count()} "
                f"(fraction {self.quorum})"
            )
        self._note_event("failed", detail="policy 'raise'")
        raise SyncTimeoutError(
            f"metric sync failed after {self.retries + 1} attempt(s) "
            f"({h.timeouts} timeouts, {h.transient_errors} transient errors "
            f"so far on this group); policy 'raise' forbids degradation"
        )

    def _local_object(self, obj: Any) -> Tuple[List[Any], List[int]]:
        if self._local_mode:
            # under LocalReplicaGroup the argument IS the per-replica list;
            # "this rank's own payload" is the controller's replica 0
            return [obj[self.rank]], [self.rank]
        return [obj], [self.rank]

    def _local_array(self, x: Any) -> Tuple[List[Any], List[int]]:
        if self._local_mode:
            return [_as_numpy(x[self.rank])], [self.rank]
        return [_as_numpy(x)], [self.rank]

    def allgather_object_with_ranks(self, obj: Any) -> Tuple[List[Any], List[int]]:
        return self._resilient(
            lambda: self._active.allgather_object(obj),
            lambda: self._local_object(obj),
            "allgather_object",
            _flight.payload_nbytes(obj),
        )

    def allgather_array_with_ranks(self, x: Any) -> Tuple[List[Any], List[int]]:
        return self._resilient(
            lambda: self._active.allgather_array(x),
            lambda: self._local_array(x),
            "allgather_array",
            _flight.payload_nbytes(x),
        )

    def _full_or_raise(self, gathered: Tuple[List[Any], List[int]]) -> List[Any]:
        """The base-class ``allgather_*`` contract is one payload per rank
        in rank order; a degraded (partial) result cannot satisfy it, and
        returning fewer entries would mis-attribute ranks in a positional
        caller. Rank-aware callers use the ``_with_ranks`` variants (as
        ``synclib`` does)."""
        values, ranks = gathered
        if len(ranks) == self.world_size:
            return values
        raise SyncTimeoutError(
            f"gather degraded to ranks {ranks} of {self.world_size}; the "
            "plain allgather contract (one payload per rank, in rank "
            "order) cannot represent a partial result — use "
            "allgather_object_with_ranks/allgather_array_with_ranks"
        )

    def allgather_object(self, obj: Any) -> List[Any]:
        return self._full_or_raise(self.allgather_object_with_ranks(obj))

    def allgather_array(self, x: Any) -> List[Any]:
        return self._full_or_raise(self.allgather_array_with_ranks(x))
