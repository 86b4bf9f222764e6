"""Collective flight recorder: per-thread rings of in-flight collectives.

Counterpart of ``torcheval_tpu/obs/flight.py``. The event stream is
*post-hoc*: events are recorded when control returns — a deadlocked
collective leaves NOTHING actionable, yet hangs are exactly the failure
mode the resilience stack (deadlines, quorum, re-formation) exists for.
Fault-tolerant collectives are only operable with a diagnosis of *which*
peer stalled and *where in the collective sequence*. This module is that
diagnosis layer:

- Every collective issued through the ``ProcessGroup`` wrapper layer
  (``distributed.py`` plain groups, ``resilience.ResilientGroup``'s
  retry loop) writes a :class:`FlightRecord` into a bounded PER-THREAD
  ring **as it happens**: state transitions
  ``enqueued -> issued -> completed | failed`` are visible mid-flight,
  so a watchdog (``obs/watchdog.py``) or a ``/flight`` scrape
  (``obs/server.py``) can see a collective that never returned.
- ``seq`` is a per-thread monotonic collective ordinal. Collectives run
  in lockstep, so every rank's N-th collective from its sync path is the
  SAME logical collective (the ``obs/trace.py`` ``next_flow_id``
  reasoning; ``flow`` additionally links each record to the eager sync
  it belongs to) — which is what makes per-rank rings *diffable* with
  zero communication.
- :func:`diff_flight_rings` is that diff: given every rank's ring it
  names the first stuck rank (lowest last-completed ``seq`` with an
  in-flight record) and any rank whose completed opcode sequence
  diverges (as :class:`CollectiveOp` plans, a copy of the JAX package's
  ``analysis/lockstep.py`` shape, so the dynamic forensics and the
  static lockstep checker speak one vocabulary).

Cost contract: every instrumented site guards on ONE attribute read
(``FLIGHT.enabled``); off is the default and costs that read alone. On,
recording is host-side list/int work under a per-thread lock — no host
sync and no extra collective on any sync path. Payload byte accounting
reads ``nbytes`` metadata only; a pickled object reports 0 rather than
forcing a serialization.

Threads: a record carries the tid of the thread that ran the collective's
group call. ``ResilientGroup`` opens its record on the caller's thread and
hands the inner gather to a deadline worker with recording suppressed
there, so one logical collective is one record on the caller's ring, as
in the JAX package.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

from torcheval_tpu_torch.obs import trace as _trace

__all__ = [
    "FLIGHT",
    "FlightDiff",
    "FlightRecord",
    "FlightRecorder",
    "FlightRing",
    "diff_flight_rings",
    "format_flight",
    "gather_flight",
]

DEFAULT_RING_CAPACITY = 256

STATES = ("enqueued", "issued", "completed", "failed")


class FlightRecord:
    """One collective's lifecycle on this thread's ring.

    ``seq`` — per-thread collective ordinal (1-based; lockstep-comparable
    across ranks); ``op`` — opcode at the group interface
    (``allgather_object`` / ``allgather_array``); ``state`` — one of
    :data:`STATES`; ``payload_bytes`` — local payload size when knowable
    from host metadata (0 otherwise); ``ranks`` — participating ranks of
    the completed collective (empty until completion); ``attempts`` —
    issue attempts (resilience retries); ``t_*`` — wall timestamps of
    each transition (0.0 = not reached); ``m_last`` — monotonic time of
    the last transition (what the watchdog ages against).
    """

    __slots__ = (
        "seq", "op", "state", "payload_bytes", "ranks", "rank",
        "world_size", "attempts", "flow", "tid", "detail", "tracked",
        "t_enqueued", "t_issued", "t_done", "m_last",
    )

    def __init__(
        self,
        seq: int,
        op: str,
        *,
        payload_bytes: int = 0,
        rank: int = 0,
        world_size: int = 0,
        state: str = "enqueued",
    ) -> None:
        now = time.time()
        self.seq = seq
        self.op = op
        self.state = state
        self.payload_bytes = int(payload_bytes)
        self.ranks: Tuple[int, ...] = ()
        self.rank = int(rank)
        self.world_size = int(world_size)
        # the eager-sync flow ordinal this collective belongs to (the
        # same per-thread counter SyncEvent.flow is stamped from)
        self.flow = getattr(_trace._TLS, "flow", 0)
        self.tid = threading.get_ident()
        self.detail = ""
        # True for LONG-LIVED exchange records (FlightRecorder.open —
        # inter-region links): deliberately in flight across many
        # collectives, so the watchdog does not age them and the
        # cross-rank lockstep diff does not compare them (each direction
        # has its own op name); the federation's staleness gauges are
        # their health authority
        self.tracked = False
        self.t_enqueued = now
        # a record born directly in the issued state (plain groups: no
        # queueing layer above the gather) IS its first issue attempt
        self.t_issued = now if state == "issued" else 0.0
        self.attempts = 1 if state == "issued" else 0
        self.t_done = 0.0
        self.m_last = time.monotonic()

    @property
    def in_flight(self) -> bool:
        return self.state in ("enqueued", "issued")

    def age(self, now_mono: Optional[float] = None) -> float:
        """Seconds since the last state transition."""
        return (time.monotonic() if now_mono is None else now_mono) - self.m_last

    def as_dict(self) -> Dict[str, Any]:
        return {
            "seq": self.seq,
            "op": self.op,
            "state": self.state,
            "payload_bytes": self.payload_bytes,
            "ranks": list(self.ranks),
            "rank": self.rank,
            "world_size": self.world_size,
            "attempts": self.attempts,
            "flow": self.flow,
            "tid": self.tid,
            "detail": self.detail,
            "tracked": self.tracked,
            "t_enqueued": self.t_enqueued,
            "t_issued": self.t_issued,
            "t_done": self.t_done,
        }

    def format(self) -> str:
        extra = f" [{self.detail}]" if self.detail else ""
        age = f" {self.age():.3f}s" if self.in_flight else ""
        return (
            f"#{self.seq} {self.op} {self.state}{age} "
            f"(rank {self.rank}, {self.payload_bytes}B, "
            f"attempts {self.attempts}){extra}"
        )


class FlightRing:
    """One thread's bounded flight ring (drop-oldest; completed-only
    eviction pressure in practice since at most one record is in flight
    per thread at a time)."""

    __slots__ = (
        "capacity", "records", "lock", "next_seq", "last_completed_seq",
        "completed", "failed", "rank", "tid",
    )

    def __init__(self, capacity: int, tid: int) -> None:
        self.capacity = int(capacity)
        self.records: List[FlightRecord] = []  # tev: guarded-by=lock
        self.lock = threading.Lock()
        self.next_seq = 1  # tev: guarded-by=lock
        self.last_completed_seq = 0  # tev: guarded-by=lock
        self.completed = 0  # tev: guarded-by=lock
        self.failed = 0  # tev: guarded-by=lock
        # last-known rank attribution of this thread
        self.rank = 0  # tev: guarded-by=lock
        self.tid = tid

    def append(self, record: FlightRecord) -> None:
        with self.lock:
            if record.tracked:
                # tracked exchanges stay OUT of the lockstep ordinal: a
                # leader interleaving link records with collectives must
                # not read "ahead" of its followers in last_completed
                # comparisons (seq 0 = not a lockstep position)
                record.seq = 0
            else:
                record.seq = self.next_seq
                self.next_seq += 1
            self.records.append(record)
            if len(self.records) > self.capacity:
                del self.records[0]
            self.rank = record.rank

    def tail(self, n: Optional[int] = None) -> List[FlightRecord]:
        with self.lock:
            records = list(self.records)
        return records if n is None else records[-n:]


class FlightRecorder:
    """Process-global flight-recording switchboard (singleton
    :data:`FLIGHT`).

    ``enabled`` is a plain attribute — the single read every
    instrumented collective site pays when recording is off. It is
    derived from a SET of enable sources (the recorder, the watchdog, a
    user) so e.g. disabling the event recorder cannot silently strip an
    armed watchdog of its flight data.
    """

    def __init__(self, capacity: int = DEFAULT_RING_CAPACITY) -> None:
        # lock-free hot-path gate by design: every instrumented site
        # pays exactly one attribute read when recording is off; the
        # writers (enable/disable) serialize under _lock
        self.enabled: bool = False  # tev: disable=unguarded-state -- lock-free hot-path gate; writers hold _lock, readers tolerate staleness by contract
        self.capacity = int(capacity)
        self._sources: set = set()  # tev: guarded-by=_lock
        self._rings: Dict[int, FlightRing] = {}  # tev: guarded-by=_lock
        self._lock = threading.Lock()
        self._tls = threading.local()
        # bumped by reset(): other threads' cached TLS rings detect the
        # wipe on next use instead of writing into an orphaned ring
        self._generation = 0  # tev: guarded-by=_lock
        # bumped on EVERY state transition: the watchdog's cheap
        # "did anything move since I last looked" probe
        self.progress = 0  # tev: disable=unguarded-state -- monotonic progress probe; a racy lost increment only delays the watchdog one poll tick, never blocks

    # ------------------------------------------------------------ lifecycle

    def enable(self, source: str = "user") -> None:
        with self._lock:
            self._sources.add(source)
            self.enabled = True

    def disable(self, source: str = "user") -> None:
        with self._lock:
            self._sources.discard(source)
            self.enabled = bool(self._sources)

    def reset(self) -> None:
        """Drop every thread's ring (tests and benchmarks; the enabled flag and
        sources are untouched)."""
        with self._lock:
            self._rings.clear()
            self._generation += 1

    # ------------------------------------------------------------ recording

    def _ring(self) -> FlightRing:
        ring = getattr(self._tls, "ring", None)
        if (
            ring is not None
            and getattr(self._tls, "generation", -1) == self._generation  # tev: disable=guarded-field -- racy fast-path generation probe; a stale read only defers fresh-ring adoption to the locked re-stamp below
        ):
            return ring
        tid = threading.get_ident()
        ring = FlightRing(self.capacity, tid)
        with self._lock:
            self._rings[tid] = ring
            self._tls.generation = self._generation
        self._tls.ring = ring
        return ring

    def start(
        self,
        op: str,
        *,
        payload_bytes: int = 0,
        rank: int = 0,
        world_size: int = 0,
        state: str = "issued",
    ) -> Optional[FlightRecord]:
        """Open one collective record on this thread's ring (``None``
        when disabled, or when a record is already open on this thread —
        a wrapped group's inner gather is the same logical collective
        the outer ``ResilientGroup`` site already opened)."""
        if not self.enabled:
            return None
        depth = getattr(self._tls, "depth", 0)
        if depth:
            return None
        self._tls.depth = 1
        record = FlightRecord(
            0, op, payload_bytes=payload_bytes, rank=rank,
            world_size=world_size, state=state,
        )
        self._ring().append(record)
        self.progress += 1
        return record

    def open(
        self,
        op: str,
        *,
        payload_bytes: int = 0,
        rank: int = 0,
        world_size: int = 0,
        state: str = "issued",
    ) -> Optional[FlightRecord]:
        """Open a LONG-LIVED tracked record (``None`` when disabled) —
        the inter-region link shape (``federation.py``): an exchange that
        stays in flight across many collectives on this thread, so it
        must bypass the one-record-per-thread depth guard ``start`` uses
        for wrapped collectives. Tracked records are exempt from the
        stall watchdog's aging and from the lockstep divergence diff
        (see :class:`FlightRecord`). Close with :meth:`close` (NOT
        ``complete``/``fail``, whose depth bookkeeping belongs to
        ``start``)."""
        if not self.enabled:
            return None
        record = FlightRecord(
            0, op, payload_bytes=payload_bytes, rank=rank,
            world_size=world_size, state=state,
        )
        record.tracked = True
        self._ring().append(record)
        self.progress += 1
        return record

    def close(
        self,
        record: Optional[FlightRecord],
        *,
        failed: bool = False,
        ranks: Tuple[int, ...] = (),
        detail: str = "",
    ) -> None:
        """Finish a tracked record from :meth:`open` (completed or
        failed) without touching the depth guard — safe to call even
        while an ordinary collective record is open on this thread.
        ``last_completed_seq`` is deliberately NOT advanced: that
        ordinal encodes cross-rank LOCKSTEP progress, and tracked
        exchanges are not lockstep collectives."""
        if record is None:
            return
        record.t_done = time.time()
        record.ranks = tuple(ranks)
        if detail:
            record.detail = detail
        self._transition(record, "failed" if failed else "completed")
        ring = self._ring()
        with ring.lock:
            if failed:
                ring.failed += 1
            else:
                ring.completed += 1

    def _transition(self, record: FlightRecord, state: str) -> None:
        record.state = state
        record.m_last = time.monotonic()
        self.progress += 1

    def issued(self, record: Optional[FlightRecord]) -> None:
        if record is None:
            return
        record.attempts += 1
        if record.t_issued == 0.0:
            record.t_issued = time.time()
        self._transition(record, "issued")

    def complete(
        self,
        record: Optional[FlightRecord],
        *,
        ranks: Tuple[int, ...] = (),
        detail: str = "",
    ) -> None:
        if record is None:
            return
        self._tls.depth = 0
        record.t_done = time.time()
        record.ranks = tuple(ranks)
        if detail:
            record.detail = detail
        self._transition(record, "completed")
        ring = self._ring()
        with ring.lock:
            ring.completed += 1
            if record.seq > ring.last_completed_seq:
                ring.last_completed_seq = record.seq

    def fail(self, record: Optional[FlightRecord], detail: str = "") -> None:
        if record is None:
            return
        self._tls.depth = 0
        record.t_done = time.time()
        if detail:
            record.detail = detail
        self._transition(record, "failed")
        ring = self._ring()
        with ring.lock:
            ring.failed += 1

    # ------------------------------------------------------------- reading

    def rings(self) -> Dict[int, FlightRing]:
        with self._lock:
            return dict(self._rings)

    def snapshot(self, tail: Optional[int] = None) -> Dict[int, Dict[str, Any]]:
        """Point-in-time copy of every thread's ring:
        ``{tid: {"rank", "last_completed_seq", "records": [dict, ...]}}``."""
        out: Dict[int, Dict[str, Any]] = {}
        for tid, ring in sorted(self.rings().items()):
            records = ring.tail(tail)
            out[tid] = {
                "tid": tid,
                "rank": ring.rank,
                "last_completed_seq": ring.last_completed_seq,
                "completed": ring.completed,
                "failed": ring.failed,
                "records": [r.as_dict() for r in records],
            }
        return out

    def per_rank(self, tail: Optional[int] = None) -> Dict[int, List[Dict]]:
        """The snapshot re-keyed by RANK (``{rank: [record dicts]}``) —
        the :func:`diff_flight_rings` input shape. In-process worlds
        (``ThreadWorld``: one thread per rank) yield one entry per rank;
        a plain multi-host process yields its own rank only (gather
        peers' snapshots with :func:`gather_flight` first)."""
        out: Dict[int, List[Dict]] = {}
        for ring in self.snapshot(tail).values():
            for rec in ring["records"]:
                out.setdefault(int(rec["rank"]), []).append(rec)
        for records in out.values():
            records.sort(key=lambda r: r["seq"])
        return out

    def in_flight(self) -> List[FlightRecord]:
        """Every record currently enqueued/issued, across all threads."""
        out = []
        for ring in self.rings().values():
            out.extend(r for r in ring.tail() if r.in_flight)
        return out

    def counters(self) -> Dict[str, Any]:
        """Pull-based counter-source payload (``obs.default_registry``'s
        ``flight`` source)."""
        rings = self.rings()
        completed = sum(r.completed for r in rings.values())
        failed = sum(r.failed for r in rings.values())
        return {
            "enabled": int(self.enabled),
            "threads": len(rings),
            "completed_total": completed,
            "failed_total": failed,
            "in_flight": len(self.in_flight()),
            "progress_total": self.progress,
        }

    def tail_text(self, n: int = 8) -> str:
        """This thread's newest ``n`` records as one compact line block —
        what ``ResilientGroup`` attaches to timeout errors and
        ``RetryEvent.flight``."""
        try:
            ring = self._tls.ring
        except AttributeError:
            return ""
        return "; ".join(r.format() for r in ring.tail(n))


FLIGHT = FlightRecorder()


def guarded_collective(op: str, payload_bytes: int, rank: int, world: int, fn):
    """Run ``fn()`` under one flight record (the plain-group
    instrumentation shape: start-as-issued, complete/fail). Callers gate
    on ``FLIGHT.enabled`` first so the off path never reaches here."""
    record = FLIGHT.start(
        op, payload_bytes=payload_bytes, rank=rank, world_size=world
    )
    try:
        out = fn()
    except BaseException as e:  # noqa: BLE001 — recorded then re-raised
        FLIGHT.fail(record, f"{type(e).__name__}: {e}")
        raise
    FLIGHT.complete(record, ranks=tuple(range(world)))
    return out


def suppressed(fn):
    """Run ``fn()`` with this thread's flight recording suppressed — the
    wrapper a decorating group (``ResilientGroup``) applies to the inner
    gather it hands to its deadline WORKER thread: the worker's own
    thread-local depth guard cannot see the caller thread's open record,
    and without this the same logical collective would be recorded twice
    on two rings."""
    tls = FLIGHT._tls
    depth = getattr(tls, "depth", 0)
    tls.depth = depth + 1
    try:
        return fn()
    finally:
        tls.depth = depth


def payload_nbytes(x: Any) -> int:
    """Host-metadata-only payload size: ``nbytes`` for an array or a
    tensor (shape and dtype metadata, no device read), 0 for anything
    else (a pickled object would need a serialization — never on the sync
    path). The JAX package's rule, so both report the same bytes for the
    same payloads."""
    nbytes = getattr(x, "nbytes", None)
    if isinstance(nbytes, int):
        return nbytes
    return 0


# ---------------------------------------------------------------- analysis


class CollectiveOp(NamedTuple):
    """One collective in a rank's ordered plan: the port's copy of the JAX
    package's ``analysis.lockstep.CollectiveOp``. Two ops rendezvous when
    their ``key`` (name, axes) agrees; ``context`` and ``provenance`` are
    diagnostics."""

    name: str
    axes: Tuple[str, ...] = ()
    context: Tuple[str, ...] = ()
    provenance: str = ""

    @property
    def key(self) -> Tuple[str, Tuple[str, ...]]:
        return (self.name, self.axes)


class FlightDiff:
    """Result of :func:`diff_flight_rings` (see there)."""

    __slots__ = (
        "ok", "stalled_rank", "stalled_seq", "stalled_op", "stalled_age",
        "diverged_rank", "divergence_seq", "last_completed", "findings",
    )

    def __init__(self) -> None:
        self.ok = True
        self.stalled_rank: Optional[int] = None
        self.stalled_seq: Optional[int] = None  # last COMPLETED seq there
        self.stalled_op: str = ""
        self.stalled_age: float = 0.0
        self.diverged_rank: Optional[int] = None
        self.divergence_seq: Optional[int] = None
        self.last_completed: Dict[int, int] = {}
        self.findings: List[str] = []

    def format(self) -> str:
        if self.ok:
            return "flight rings consistent: no stall, no divergence"
        return "\n".join(self.findings)


def _completed_ops(records: List[Dict]) -> List:
    """A rank's completed records as :class:`CollectiveOp` shapes, in seq
    order — the shared vocabulary between this dynamic diff and the
    static lockstep checker."""
    return [
        CollectiveOp(
            name=str(r["op"]),
            provenance=f"seq {r['seq']}",
        )
        for r in records
        # tracked exchanges (inter-region links) are not lockstep
        # collectives: each direction carries its own op name, so
        # comparing them across ranks would fabricate a divergence on
        # perfectly healthy links
        if r["state"] == "completed" and not r.get("tracked")
    ]


def diff_flight_rings(
    per_rank: Dict[int, List[Dict[str, Any]]],
    *,
    stall_after: float = 5.0,
) -> FlightDiff:
    """Cross-rank flight-ring analysis: WHO is stuck, WHERE in the
    collective sequence, and does anyone's sequence diverge.

    ``per_rank`` maps rank -> that rank's flight records (dicts from
    :meth:`FlightRecorder.per_rank`, a :func:`gather_flight` result's
    ``per_rank`` table, or :class:`FlightRecord` objects). Ranks' rings
    are comparable because ``seq`` is a lockstep ordinal (module
    docstring). Returns a :class:`FlightDiff`:

    - **stall**: a rank holding an in-flight (enqueued/issued) record is
      stuck when its last-completed ``seq`` is BEHIND some peer's (they
      advanced past it and are blocked waiting), or — the symmetric-hang
      case, every rank equally deep in a dead collective — when its
      in-flight record is older than ``stall_after`` seconds of wall
      time (a healthy snapshot catches ranks mid-collective for
      milliseconds, not seconds). The lowest-progress such rank is
      ``stalled_rank``; ``stalled_seq`` is its last completed ordinal,
      ``stalled_op`` the opcode it is stuck in.
    - **divergence**: ranks' completed opcode sequences are diffed as
      :class:`CollectiveOp` plans; the
      first mismatching position names a would-deadlock divergence
      (ranks issuing different collectives can never rendezvous).

    TRACKED records (``FlightRecorder.open`` — federation link
    exchanges) take neither path directly: they are excluded from the
    lockstep ordinal and the divergence diff (each direction has its own
    op name), and the stall arm counts one only once it was RE-issued
    with no ack in between (``attempts >= 2``) AND aged past
    ``stall_after`` — a healthy un-acked exchange waits out one interval
    with ``attempts == 1``, a partitioned region's probe record does not.
    """
    diff = FlightDiff()
    norm: Dict[int, List[Dict]] = {}
    for rank, records in per_rank.items():
        norm[int(rank)] = [
            r.as_dict() if isinstance(r, FlightRecord) else dict(r)
            for r in records
        ]
    if not norm:
        return diff
    for rank, records in sorted(norm.items()):
        # lockstep progress counts ordinary collectives only (tracked
        # exchange records complete at link cadence, not in lockstep)
        completed = [
            r["seq"]
            for r in records
            if r["state"] == "completed" and not r.get("tracked")
        ]
        diff.last_completed[rank] = max(completed, default=0)

    # stall: in-flight records, lowest-progress rank first
    def _age(rec: Dict) -> float:
        issued = rec.get("t_issued") or rec.get("t_enqueued") or 0.0
        return max(time.time() - issued, 0.0) if issued else 0.0

    max_completed = max(diff.last_completed.values())

    def _stuck_records(rank: int) -> List[Dict]:
        out = []
        behind = diff.last_completed[rank] < max_completed
        for rec in norm[rank]:
            if rec["state"] not in ("enqueued", "issued"):
                continue
            if rec.get("tracked"):
                # a tracked link exchange legitimately stays in flight
                # for a whole inter-exchange interval; it is STUCK only
                # once it was RE-issued with no ack in between (the
                # federation probe path) AND has aged past the bound —
                # that is the partitioned-region signature
                if rec.get("attempts", 1) >= 2 and _age(rec) >= stall_after:
                    out.append(rec)
            elif behind or _age(rec) >= stall_after:
                out.append(rec)
        return out

    stuck_by_rank = {r: _stuck_records(r) for r in norm}
    stuck_ranks = sorted(
        (r for r, recs in stuck_by_rank.items() if recs),
        key=lambda r: (diff.last_completed[r], r),
    )
    if stuck_ranks:
        rank = stuck_ranks[0]
        stuck = stuck_by_rank[rank][0]
        diff.ok = False
        diff.stalled_rank = rank
        diff.stalled_seq = diff.last_completed[rank]
        diff.stalled_op = str(stuck["op"])
        diff.stalled_age = _age(stuck)
        behind = diff.last_completed[rank] < max_completed
        diff.findings.append(
            f"rank {rank} stalled in {diff.stalled_op} "
            f"(collective seq {stuck['seq']}); its last completed seq is "
            f"{diff.stalled_seq} while peers reached {max_completed}"
            if behind
            else (
                f"all ranks stalled; rank {rank} has been in "
                f"{diff.stalled_op} (collective seq {stuck['seq']}) for "
                f"{diff.stalled_age:.1f}s with last completed seq "
                f"{diff.stalled_seq}"
            )
        )

    # divergence: diff completed opcode sequences (CollectiveOp keys)
    plans = {rank: _completed_ops(records) for rank, records in norm.items()}
    ranks = sorted(plans)
    base_rank, base = ranks[0], plans[ranks[0]]
    for rank in ranks[1:]:
        plan = plans[rank]
        n = min(len(base), len(plan))
        for i in range(n):
            if plan[i].key != base[i].key:
                diff.ok = False
                diff.diverged_rank = rank
                diff.divergence_seq = i + 1
                diff.findings.append(
                    f"rank {rank} diverges from rank {base_rank} at "
                    f"collective seq {i + 1}: {plan[i].name} vs "
                    f"{base[i].name} — mismatched collectives never "
                    "rendezvous (would-deadlock)"
                )
                break
        if diff.diverged_rank is not None:
            break
    return diff


def format_flight(snapshot: Optional[Dict] = None) -> str:
    """Human-readable dump of every thread's flight ring (default: the
    live global snapshot) — what the watchdog writes to stderr."""
    if snapshot is None:
        snapshot = FLIGHT.snapshot()
    lines = ["flight rings", "=" * 12]
    for tid, ring in sorted(snapshot.items()):
        lines.append(
            f"[tid {tid} rank {ring['rank']}] last completed seq "
            f"{ring['last_completed_seq']} "
            f"({ring['completed']} completed, {ring['failed']} failed)"
        )
        for rec in ring["records"][-16:]:
            state = rec["state"]
            marker = " <-- IN FLIGHT" if state in ("enqueued", "issued") else ""
            lines.append(
                f"  #{rec['seq']:<4} {rec['op']:<18} {state:<9} "
                f"{rec['payload_bytes']}B attempts={rec['attempts']}"
                f"{marker}"
            )
    return "\n".join(lines) + "\n"


def gather_flight(group, *, tail: int = 64) -> Dict[str, Any]:
    """Merge every rank's flight snapshot through ``group`` in ONE
    ``allgather_object`` (the ``gather_observability`` discipline: every
    member calls it in step, never on the metric-sync path — and the
    gather itself is NOT flight-recorded, it is the diagnosis channel).

    Returns ``{"world_size", "ranks", "per_rank": {rank: [records]}}`` —
    feed ``per_rank`` straight to :func:`diff_flight_rings`.
    """
    contribution = {"rank": group.rank, "flight": FLIGHT.per_rank(tail)}
    # the diagnosis gather stays out of its own data: suppress this
    # thread's group-layer instrumentation for the call
    gathered = suppressed(lambda: group.allgather_object(contribution))
    per_rank: Dict[int, List[Dict]] = {}
    for c in gathered:
        for rank, records in c["flight"].items():
            per_rank.setdefault(int(rank), []).extend(records)
    for records in per_rank.values():
        records.sort(key=lambda r: r["seq"])
    return {
        "world_size": group.world_size,
        "ranks": sorted(per_rank),
        "per_rank": per_rank,
    }
