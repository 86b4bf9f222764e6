"""Zero-stall sync plane: background collectives, versioned snapshots and
bounded-staleness reads.

Counterpart of ``torcheval_tpu/syncplane.py``. ``sync_and_compute`` stalls
its caller for a whole collective round trip; :class:`SyncPlane` moves the
round off the serving path, in three pieces:

**Versioned snapshot publication** (serving thread: no collective, no
host sync). :meth:`SyncPlane.publish` copies the live collection's trimmed
sync payloads (``_sync_state_dict``: a buffer's valid prefix, an outbox's
live entries, each cut before it is copied). The states are written in
place by later updates, CUDA-graph replays and loads, so the record holds
copies, never the live tensors. On the card the copies are enqueued on the
serving stream and an event is recorded beside them; nothing waits for
them there. The record is swapped in whole under the plane lock.

**A background sync round** (plane thread). The thread wakes at
``interval``, sets its own device, waits for the published copies' event
on a stream of its own (``record_stream`` keeps their memory alive for
it), loads them into fresh clones and runs the unchanged eager sync
(``toolkit.get_synced_metric_collection``) on a dedicated communicator:
``group.new_subgroup(all ranks)`` wrapped in a
``resilience.ResilientGroup``, so its collectives never pair off against
serving-thread syncs on the parent group. Over processes that subgroup is
a ``torch.distributed.new_group`` which every rank makes when it builds
its plane, in the same order. A round's host work (the numpy pack, the
crc) holds the interpreter lock, so what the plane costs serving is host
time.

**Bounded-staleness reads** (any thread, non-blocking).
:meth:`SyncPlane.read` / :meth:`SyncPlane.compute` and the toolkit's and
federation's ``plane=`` forms return the freshest merged snapshot, its
``sync_provenance`` carrying ``version``, ``rounds_behind`` and
``wall_age_seconds``.

Correctness contract: a read at version V equals, bit for bit, a blocking
``sync_and_compute`` over the states published for V. ``reset()`` and
``load_state_dict`` bump a metric's ``_state_epoch``; a snapshot captured
at an older epoch is discarded at read time (the read falls back to a
local clone with degraded, version-0 provenance).

Observability: each round records a ``PlaneSyncEvent`` (the eager
protocol adds its own ``SyncEvent`` and flight records), an open plane
exports the ``syncplane`` counter source, and ``/healthz`` reports
``stale-plane`` once the freshest merged snapshot ages past
``stale_after``.

::

    plane = SyncPlane({"acc": acc, "loss": loss}, group, interval=2.0)
    for batch in loader:
        acc.update(*batch)           # never blocks: no collective
        plane.publish()              # copies of the trimmed states
        values = plane.compute()     # freshest merged, with staleness
    plane.close()
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
import warnings
from typing import Any, Dict, Iterator, NamedTuple, Optional, Sequence, Union

import torch

from torcheval_tpu_torch.distributed import (
    LocalReplicaGroup,
    ProcessGroup,
    default_process_group,
)
from torcheval_tpu_torch.metrics.metric import Metric
from torcheval_tpu_torch.obs.recorder import RECORDER as _OBS
from torcheval_tpu_torch.resilience import ResilientGroup, SyncProvenance

__all__ = ["SyncPlane", "current_plane"]

_logger: logging.Logger = logging.getLogger(__name__)


class _Published(NamedTuple):
    """One immutable published-state record (swapped as a whole)."""

    generation: int
    states: Dict[str, Dict[str, Any]]  # {metric: trimmed sync payload}
    epochs: Dict[str, int]  # {metric: _state_epoch at capture}
    wall: float
    event: Optional[Any] = None  # CUDA event after the copies, on the card


class _Merged(NamedTuple):
    """One immutable merged-snapshot record (swapped as a whole)."""

    version: int
    generation: int  # publish generation this round consumed
    metrics: Dict[str, Metric]  # merged clones — treated as immutable
    base: SyncProvenance  # the round's sync provenance (staleness unset)
    epochs: Dict[str, int]
    wall: float


class SyncPlane:
    """Asynchronous eval plane for one ``{name: Metric}`` collection.

    Args:
        metrics: the LIVE serving collection (or a single
            :class:`Metric`, wrapped like the toolkit does). The plane
            holds references: reads validate published snapshots against
            these instances' ``_state_epoch``.
        process_group: the rank world (default
            ``distributed.default_process_group()``). The plane derives
            a DEDICATED whole-world subgroup from it; per-replica
            ``LocalReplicaGroup`` worlds are not supported (one plane
            per logical rank, like ``elastic.ElasticSession``).
        interval: background round cadence in seconds; ``None`` (default)
            arms no thread — call :meth:`run_round` yourself (tests,
            deterministic loops, callers with their own scheduler).
        timeout / retries / policy / quorum / reform_after: the
            ``resilience.ResilientGroup`` knobs for
            the plane's communicator (defaults from ``config``, like any
            sync). A degrading policy is strongly recommended for an
            armed plane: it bounds what a dead rank can cost a round.
        history: merged snapshot versions retained for
            :meth:`snapshot_at` (federation version-agreement reads).
        stale_after: ``/healthz`` degradation bound in seconds — the
            plane reports stale once its freshest merged snapshot (or,
            before the first round, its arm time) ages past this.
            Default: ``10 * interval`` when a thread is armed, else
            disabled; ``0`` disables explicitly.
    """

    def __init__(
        self,
        metrics: Union[Metric, Dict[str, Metric]],
        process_group: Optional[ProcessGroup] = None,
        *,
        interval: Optional[float] = None,
        timeout: Optional[float] = None,
        retries: Optional[int] = None,
        policy: Optional[str] = None,
        quorum: Optional[float] = None,
        reform_after: Optional[int] = None,
        history: int = 4,
        stale_after: Optional[float] = None,
    ) -> None:
        if isinstance(metrics, Metric):
            metrics = {"_metric": metrics}
        if not metrics or not all(
            isinstance(m, Metric) for m in metrics.values()
        ):
            raise TypeError(
                "metrics must be a Metric or a non-empty {name: Metric} "
                "dict holding this rank's live metrics"
            )
        self.metrics: Dict[str, Metric] = dict(metrics)
        group = (
            process_group
            if process_group is not None
            else default_process_group()
        )
        if isinstance(group.unwrap(), LocalReplicaGroup):
            raise TypeError(
                "SyncPlane syncs one rank's metrics per plane; a "
                "LocalReplicaGroup's per-replica metric lists are not "
                "supported — run one plane per logical rank"
            )
        if not group.is_member:
            raise ValueError(
                "this process is not a member of the given process group"
            )
        self._group = group  # tev: disable=unguarded-state -- reassigned only by reform() under the _round_lock quiesce fence (no round in flight across the swap); every other write is __init__
        # kept so a failover reform can derive a fresh dedicated
        # communicator for the survivor world with IDENTICAL semantics
        self._comm_knobs: Dict[str, Any] = dict(
            timeout=timeout,
            retries=retries,
            policy=policy,
            quorum=quorum,
            reform_after=reform_after,
        )
        self._comm: ProcessGroup = self._dedicated_comm(**self._comm_knobs)  # tev: disable=unguarded-state -- reassigned only by reform() under the _round_lock quiesce fence; the round thread reads it inside the same fence
        if interval is not None and interval <= 0:
            raise ValueError(f"interval must be > 0 seconds, got {interval}")
        self.interval = interval
        if history < 1:
            raise ValueError(f"history must be >= 1, got {history}")
        self.history = int(history)
        if stale_after is None:
            stale_after = 10.0 * interval if interval is not None else 0.0
        self.stale_after = float(stale_after)
        # templates frozen at construction: each round clones these and
        # loads the published payload over them, so a round never reads
        # the LIVE metrics (the serving thread owns those)
        import copy as _copy

        self._templates: Dict[str, Metric] = {
            name: _copy.deepcopy(m).reset() for name, m in self.metrics.items()
        }
        self._lock = threading.Lock()
        self._published: Optional[_Published] = None  # tev: guarded-by=_lock
        self._publish_gen = 0  # tev: guarded-by=_lock
        self._merged: Optional[_Merged] = None  # tev: guarded-by=_lock
        self._version = 0  # tev: guarded-by=_lock
        self._history: Dict[int, _Merged] = {}  # tev: guarded-by=_lock
        self.rounds = 0  # tev: guarded-by=_lock
        self.degraded_rounds = 0  # tev: guarded-by=_lock
        self.round_errors = 0  # tev: guarded-by=_lock
        self.last_error: Optional[str] = None  # tev: guarded-by=_lock
        self.reads = 0  # tev: guarded-by=_lock
        self.cold_reads = 0  # tev: guarded-by=_lock
        # quiesce fence: every round holds it for the round's duration;
        # holders (elastic snapshot/restore) exclude rounds, not reads
        self._round_lock = threading.Lock()  # tev: disable=bare-lock -- serializes round EXECUTION (the quiesce fence), not data: every shared field is bound to _lock; binding a field here would misdescribe the contract
        self._stop = threading.Event()
        self._armed_wall = time.time()
        self._thread: Optional[threading.Thread] = None
        # the card the live metrics sit on, which the plane thread sets as
        # its own, and the stream it runs rounds on (made there)
        self._device = next(
            (m.device for m in self.metrics.values() if m.device.type == "cuda"), None
        )
        self._stream: Optional[Any] = None  # tev: disable=unguarded-state -- made and used only inside rounds, which run one at a time under the _round_lock quiesce fence
        self._closed = False  # tev: disable=unguarded-state -- caller-thread lifecycle flag (close() is caller API); the round thread only reads it to exit early, and a stale read costs one bounded extra round, never a hang
        if interval is not None:
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="torcheval-syncplane"
            )
            self._thread.start()
        self._arm()

    # ------------------------------------------------------------- plumbing

    def _dedicated_comm(self, **knobs: Any) -> ProcessGroup:
        """The communicator plane rounds run on: a dedicated whole-world
        subgroup (own collective sequence — background rounds can never
        pair off against main-thread syncs on the parent group), wrapped
        with the plane's resilience knobs, as the elastic session's
        asynchronous writer gets its own communicator."""
        try:
            ded = self._group.new_subgroup(range(self._group.world_size))
        except NotImplementedError:
            ded = self._group
            if self._group.world_size > 1:
                warnings.warn(
                    f"{type(self._group).__name__} cannot scope a dedicated "
                    "plane communicator (no new_subgroup): do not issue "
                    "metric-sync collectives on this group while a plane "
                    "round may be in flight — cross-thread collectives on "
                    "one group can pair off out of order across ranks",
                    RuntimeWarning,
                )
        if isinstance(ded, ResilientGroup):
            return ded
        return ResilientGroup(ded, **knobs)

    @property
    def world_size(self) -> int:
        return self._comm.world_size

    @property
    def ranks(self) -> Sequence[int]:
        """Global ranks of the plane's world (the parent group's)."""
        return tuple(self._group.ranks)

    @property
    def rank(self) -> int:
        return self._comm.rank

    @property
    def policy(self) -> str:
        return getattr(self._comm, "degradation_policy", "raise")

    @property
    def armed(self) -> bool:
        """Whether a background round thread is running."""
        return self._thread is not None and self._thread.is_alive()

    @property
    def version(self) -> int:
        """Version of the freshest merged snapshot (0 = none yet)."""
        with self._lock:
            return self._version if self._merged is not None else 0

    @property
    def publishes(self) -> int:
        """Publish generations issued so far."""
        with self._lock:
            return self._publish_gen

    # -------------------------------------------------------------- publish

    def publish(self) -> int:
        """Copy the live collection's sync payload and swap it in as the
        newest published record (serving thread; no collective, no host
        sync: on the card the copies are enqueued on the current stream
        and an event recorded after them). Returns the publish
        generation."""
        self._check_open()
        states = {
            name: m._sync_state_dict() for name, m in self.metrics.items()
        }
        epochs = {
            name: m._state_epoch for name, m in self.metrics.items()
        }
        event = None
        if self._device is not None:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self._device))
        record = _Published(0, states, epochs, time.time(), event)
        with self._lock:
            self._publish_gen += 1
            # the record is fully built before this single-reference
            # swap: a concurrent reader sees the old record or this one,
            # never a torn mix
            self._published = record._replace(generation=self._publish_gen)
            return self._publish_gen

    # --------------------------------------------------------------- rounds

    def run_round(self) -> Optional[int]:
        """Run ONE sync round now (every rank's plane must run rounds in
        step — the round is a collective). The armed thread calls this on
        its own cadence; manual planes (``interval=None``) call it from
        their scheduler or tests. Returns the new merged version, or
        ``None`` when nothing has been published yet."""
        self._check_open()
        with self._round_lock:
            return self._round()  # tev: disable=blocking-under-lock -- the quiesce fence intentionally spans the round's collectives (that is its contract: no round in flight while held); _round_lock is a leaf — the collective path takes only _lock briefly and never _round_lock, and the communicator's deadline bounds the wait

    def _round(self) -> Optional[int]:
        if self._device is None:
            return self._round_on_stream()
        if self._stream is None:
            # first round on this thread: the plane's own device and stream
            torch.cuda.set_device(self._device)
            self._stream = torch.cuda.Stream(self._device)
        with torch.cuda.stream(self._stream):
            version = self._round_on_stream()
        # the merged clones are complete before any reader sees them
        self._stream.synchronize()
        return version

    def _round_on_stream(self) -> Optional[int]:
        from torcheval_tpu_torch.metrics.toolkit import (
            clone_metric,
            get_synced_metric_collection,
        )

        with self._lock:
            pub = self._published
        if self._comm.world_size > 1:
            # readiness agreement: a rank with nothing published (fresh
            # plane, or just invalidated by an elastic restore) must not
            # silently sit out while its peers rendezvous on the state
            # sync — every rank gathers its publish generation first and
            # the round proceeds only when ALL ranks have one (the tiny
            # gather rides the plane's own communicator and policy, so a
            # DEAD rank still degrades instead of hanging)
            flags = self._comm.allgather_object(
                int(pub.generation) if pub is not None else 0
            )
            if any(int(f) == 0 for f in flags):
                return None
        if pub is None:
            return None
        if pub.event is not None:
            # the published copies were enqueued on the serving stream:
            # order this stream after them, and keep their memory from
            # being reused before this stream is done with it
            self._stream.wait_event(pub.event)
            for states in pub.states.values():
                for t in _tensors(states):
                    if t.is_cuda:
                        t.record_stream(self._stream)
        t0 = time.monotonic()
        coll: Dict[str, Metric] = {}
        for name, template in self._templates.items():
            clone = clone_metric(template)
            clone.load_state_dict(pub.states[name], strict=False)
            coll[name] = clone
        if self._comm.world_size == 1:
            # world-of-one fast path: the local payload IS the merged
            # state; skip the toolkit's per-round world-1 warning
            provenance = SyncProvenance(
                ranks=(self._comm.rank,),
                world_size=1,
                degraded=False,
                policy=self.policy,
            )
            synced = coll
            for m in synced.values():
                m.sync_provenance = provenance
        else:
            synced = get_synced_metric_collection(coll, self._comm)
            provenance = next(iter(synced.values())).sync_provenance
        seconds = time.monotonic() - t0
        now = time.time()
        with self._lock:
            self._version += 1
            record = _Merged(
                self._version, pub.generation, synced, provenance, pub.epochs,
                now,
            )
            self._merged = record
            self._history[record.version] = record
            for old in [
                v for v in self._history if v <= record.version - self.history
            ]:
                del self._history[old]
            self.rounds += 1
            if provenance.degraded:
                self.degraded_rounds += 1
        if _OBS.enabled:
            from torcheval_tpu_torch.obs.events import PlaneSyncEvent

            _OBS.record(
                PlaneSyncEvent(
                    rank=self._comm.rank,
                    version=record.version,
                    generation=record.generation,
                    ranks=provenance.ranks,
                    world_size=provenance.world_size,
                    degraded=provenance.degraded,
                    policy=provenance.policy,
                    reformed=provenance.reformed,
                    metrics=len(synced),
                    seconds=seconds,
                )
            )
        return record.version

    def _loop(self) -> None:  # tev: scope=syncplane
        while not self._stop.wait(self.interval):
            try:
                self.run_round()
            except Exception as e:  # noqa: BLE001 — the plane outlives a failed round
                if self._closed:
                    break  # a round racing close() is shutdown, not failure
                with self._lock:
                    self.round_errors += 1
                    self.last_error = f"{type(e).__name__}: {e}"
                _logger.warning("sync plane round failed: %s", e)
                if _OBS.enabled:
                    from torcheval_tpu_torch.obs.events import PlaneSyncEvent

                    _OBS.record(
                        PlaneSyncEvent(
                            rank=self._comm.rank,
                            policy=self.policy,
                            error=f"{type(e).__name__}: {e}",
                        )
                    )

    # ---------------------------------------------------------------- reads

    def read(
        self, names: Optional[Sequence[str]] = None
    ) -> Dict[str, Metric]:
        """Freshest merged snapshot as ``{name: Metric}`` clones, each
        carrying bounded-staleness ``sync_provenance`` (non-blocking; no
        collective, ever). A snapshot invalidated by ``reset()`` /
        ``load_state_dict`` on a live metric — or a plane that has not
        completed a round — falls back to LOCAL clones of the live
        metrics with degraded, version-0 provenance."""
        from torcheval_tpu_torch.metrics.toolkit import clone_metric

        self._check_open()
        selected = self._select(names)
        with self._lock:
            record = self._merged
            generation = self._publish_gen
        valid = record is not None and all(
            record.epochs.get(name) == self.metrics[name]._state_epoch
            for name in selected
        )
        if not valid:
            provenance = SyncProvenance(
                ranks=(self.rank,),
                world_size=self.world_size,
                degraded=self.world_size > 1,
                policy=self.policy,
            )
            out = {}
            for name in selected:
                clone = clone_metric(self.metrics[name])
                clone.sync_provenance = provenance
                out[name] = clone
            with self._lock:
                self.cold_reads += 1
            return out
        provenance = record.base._replace(
            version=record.version,
            rounds_behind=max(0, generation - record.generation),
            wall_age_seconds=max(0.0, time.time() - record.wall),
        )
        out = {}
        for name in selected:
            merged = record.metrics[name]
            clone = clone_metric(merged)
            _keep_for_current_stream(merged)
            clone.sync_provenance = provenance
            out[name] = clone
        with self._lock:
            self.reads += 1
        return out

    def compute(
        self, names: Optional[Sequence[str]] = None
    ) -> Dict[str, Any]:
        """``{name: value}`` computed from :meth:`read` (non-blocking)."""
        return {name: m.compute() for name, m in self.read(names).items()}

    def read_metric(self, metric: Union[str, Metric]) -> Metric:
        """Single-metric :meth:`read`, addressed by registered name or by
        the live instance itself (the toolkit's ``plane=`` path)."""
        name = self._name_of(metric)
        return self.read([name])[name]

    def read_collection(
        self, metrics: Dict[str, Metric]
    ) -> Dict[str, Metric]:
        """Collection :meth:`read` for ``sync_and_compute_collection
        (plane=...)``: every entry must be the SAME live instance the
        plane was built over under the SAME name — snapshot invalidation
        is validated against those instances' state epochs, so a
        look-alike collection would silently skip the validation."""
        for name, m in metrics.items():
            if self.metrics.get(name) is not m:
                self._name_of(m)  # raises with the identity message
                raise ValueError(
                    f"metric {name!r} is registered on this plane under a "
                    "different name — pass the collection the plane was "
                    "built over"
                )
        return self.read(tuple(metrics))

    def snapshot_at(self, version: int) -> Optional[Dict[str, Metric]]:
        """The RETAINED merged collection at exactly ``version`` (shared,
        treat as immutable), or ``None`` when that version was never
        produced or already evicted (``history``)."""
        with self._lock:
            record = self._history.get(int(version))
        return None if record is None else dict(record.metrics)

    def retained(self) -> Dict[int, _Merged]:
        """One consistent copy of the retained merged-version records
        (records are immutable; the dict is the caller's). This is what
        ``federation.Federation.exchange(plane=...)`` reads BEFORE its
        version-agreement gather, so the version it advertises can never
        be evicted out from under the read by a concurrent round."""
        with self._lock:
            return dict(self._history)

    def _select(self, names: Optional[Sequence[str]]) -> Sequence[str]:
        if names is None:
            return tuple(self.metrics)
        unknown = [n for n in names if n not in self.metrics]
        if unknown:
            raise KeyError(
                f"metrics {unknown} are not registered on this plane "
                f"(registered: {sorted(self.metrics)})"
            )
        return tuple(names)

    def _name_of(self, metric: Union[str, Metric]) -> str:
        if isinstance(metric, str):
            if metric not in self.metrics:
                raise KeyError(
                    f"metric {metric!r} is not registered on this plane"
                )
            return metric
        for name, m in self.metrics.items():
            if m is metric:
                return name
        raise ValueError(
            "metric is not registered on this plane — pass the same live "
            "instance the plane was built over (snapshot validation is "
            "against that instance's state epoch)"
        )

    # ------------------------------------------------------------ lifecycle

    @contextlib.contextmanager
    def quiesce(self) -> Iterator[None]:
        """Hold rounds still: no plane round starts (or is in flight)
        while the context is held. Used by elastic snapshot/restore so a
        checkpoint never interleaves with a half-merged round."""
        with self._round_lock:
            yield

    def invalidate(self) -> None:
        """Drop every published and merged snapshot (elastic restore:
        the state just loaded replaces what any snapshot describes).
        Counters keep counting — versions never move backwards."""
        with self._lock:
            self._published = None
            self._merged = None
            self._history.clear()

    def reform(self, process_group: ProcessGroup) -> None:
        """Move the plane onto a new world (``failover.FailureDomain``
        reform: the survivor subgroup after a rank loss, or the full
        group again at rejoin). Holds the quiesce fence so no round is
        in flight across the swap, derives a fresh dedicated
        communicator with the SAME resilience knobs the plane was
        constructed with, and invalidates every snapshot — they describe
        a world that no longer exists. Barrier-free: the swap itself
        issues no collective (the new communicator's first rendezvous is
        the next round's readiness gather)."""
        if not process_group.is_member:
            raise ValueError(
                "this process is not a member of the new process group"
            )
        with self._round_lock:
            self._group = process_group
            self._comm = self._dedicated_comm(**self._comm_knobs)
            self.invalidate()

    def staleness(self) -> Dict[str, Any]:
        """The plane's staleness surface (healthz / counters): freshest
        ``version``, publish ``generation`` consumed vs issued
        (``rounds_behind``), merged-snapshot ``wall_age_seconds`` (-1
        before the first round), and the ``stale`` verdict."""
        now = time.time()
        with self._lock:
            record = self._merged
            generation = self._publish_gen
            out: Dict[str, Any] = {
                "version": record.version if record is not None else 0,
                "publishes": generation,
                "rounds_behind": (
                    max(0, generation - record.generation)
                    if record is not None
                    else generation
                ),
                "wall_age_seconds": (
                    round(max(0.0, now - record.wall), 3)
                    if record is not None
                    else -1.0
                ),
                "stale_after": self.stale_after,
            }
        basis = (
            now - self._armed_wall
            if record is None
            else now - record.wall
        )
        out["stale"] = bool(
            self.stale_after > 0
            and self.armed
            and basis > self.stale_after
        )
        return out

    def stale_for_healthz(self) -> bool:
        """True when the freshest merged snapshot (or, before the first
        round, the plane's arm time) has aged past ``stale_after`` — the
        ``/healthz`` ``stale-plane`` 503 condition. Always False for
        manual (unarmed) planes and when ``stale_after`` is 0."""
        return bool(self.staleness()["stale"])

    def _counter_source(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = {
                "rounds": self.rounds,
                "degraded_rounds": self.degraded_rounds,
                "round_errors": self.round_errors,
                "reads": self.reads,
                "cold_reads": self.cold_reads,
                "armed": int(self._thread is not None),
            }
        out.update(
            (k, v)
            for k, v in self.staleness().items()
            if k != "stale_after"
        )
        out["stale"] = int(out["stale"])
        return out

    def _arm(self) -> None:
        global _CURRENT
        with _CURRENT_LOCK:
            _CURRENT = self
        from torcheval_tpu_torch.obs.counters import default_registry

        default_registry().register("syncplane", self._counter_source)

    def close(self) -> None:
        """Stop the round thread (bounded join — the communicator's
        deadline bounds a round in flight) and disarm. Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            deadline = getattr(self._comm, "timeout", None)
            retries = getattr(self._comm, "retries", 0) or 0
            grace = (
                (deadline or 0.0) * (1 + retries) + 5.0
                if deadline is not None
                else 30.0
            )
            thread.join(timeout=grace)
            if thread.is_alive():
                warnings.warn(
                    "sync plane thread did not stop within its deadline "
                    "budget; leaving the daemon thread behind",
                    RuntimeWarning,
                )
        global _CURRENT
        was_current = False
        with _CURRENT_LOCK:
            if _CURRENT is self:
                _CURRENT = None
                was_current = True
        if was_current:
            from torcheval_tpu_torch.obs.counters import default_registry

            default_registry().unregister("syncplane")

    def __enter__(self) -> "SyncPlane":
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> None:
        self.close()

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("SyncPlane is closed")


def _tensors(states: Dict[str, Any]) -> Iterator[torch.Tensor]:
    for value in states.values():
        if isinstance(value, torch.Tensor):
            yield value
        elif isinstance(value, (list, tuple)):
            yield from (v for v in value if isinstance(v, torch.Tensor))
        elif isinstance(value, dict):
            yield from (v for v in value.values() if isinstance(v, torch.Tensor))


def _keep_for_current_stream(metric: Metric) -> None:
    """A merged record's tensors were made on the plane thread's stream;
    a read copies them on the reader's. Mark them used there, so a later
    eviction of the record cannot hand their memory to the plane stream
    before the copy ran."""
    states = {name: getattr(metric, name) for name in metric._state_name_to_default}
    for t in _tensors(states):
        if t.is_cuda:
            t.record_stream(torch.cuda.current_stream(t.device))


_CURRENT: Optional[SyncPlane] = None  # tev: guarded-by=_CURRENT_LOCK
_CURRENT_LOCK = threading.Lock()


def current_plane() -> Optional[SyncPlane]:
    """The most recently armed, not-yet-closed plane (the ``/healthz``
    staleness probe's handle), or ``None``."""
    return _CURRENT  # tev: disable=guarded-field -- single-reference read, atomic under the GIL; the healthz probe tolerates a one-scrape-stale plane
