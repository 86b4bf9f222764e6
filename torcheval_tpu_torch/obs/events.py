"""Typed lifecycle events for the observability subsystem.

Counterpart of ``torcheval_tpu/obs/events.py``: the same dataclasses,
fields, ``kind`` names and ``SCHEMA_VERSION``, so a JSONL stream written
by either package reads back in the other. One dataclass per event the
eval stack emits. Every event carries the same timing envelope:

- ``t_mono``: ``time.monotonic()`` at record time — orders events and
  yields durations immune to wall-clock steps;
- ``t_wall``: ``time.time()`` — correlates with external logs/dashboards;
- ``step``: the recorder's step cursor (``Recorder.set_step``;
  ``elastic.ElasticSession`` advances it automatically), ``None`` when no
  loop is driving one;
- ``rank``: the emitting rank for group-scoped events (sync, retry,
  snapshot, restore); ``None`` for process-local events (update, compute,
  compile, span);
- ``tid``: the emitting thread's identifier (stamped by
  ``Recorder.record`` — the Chrome exporter's per-thread tracks);
- ``trace``/``span``/``parent``: the causal-tracing ids
  (``obs/trace.py``) — duration events carry their OWN span id (+ the
  parent they nest under); point events recorded inside a span carry
  the trace id and that span as ``parent``. ``None`` everywhere when no
  span is open.

Events are plain data: construct them anywhere, compare them with ``==``,
serialize with :meth:`Event.as_dict` (JSON-safe: tuples become lists, and
every dict carries ``"schema": SCHEMA_VERSION`` so readers can detect
future layout changes) and reconstruct with :func:`event_from_dict` (the
JSONL exporter's round-trip contract; unknown fields from newer writers
are ignored).

Durations (``seconds``) are host wall time from ``time.monotonic``: on
the card an update or compute returns once its kernels are enqueued, so
its ``seconds`` is the time to enqueue them, not their device time.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, ClassVar, Dict, Optional, Tuple, Type

__all__ = [
    "SCHEMA_VERSION",
    "AlertEvent",
    "AnalysisEvent",
    "CompileEvent",
    "ComputeEvent",
    "DriftEvent",
    "Event",
    "FailoverEvent",
    "MemoryEvent",
    "PlaneSyncEvent",
    "RegionSyncEvent",
    "RestoreEvent",
    "RetryEvent",
    "SnapshotEvent",
    "SpanEvent",
    "StallEvent",
    "SyncEvent",
    "UpdateEvent",
    "WireTierEvent",
    "event_from_dict",
]

# Bumped only on an incompatible layout change; new OPTIONAL fields do
# not bump it (readers ignore unknown keys by contract).
SCHEMA_VERSION = 1


@dataclass
class Event:
    """Common timing envelope; see the module docstring for field
    semantics. ``Recorder.record`` stamps the envelope when unset, so
    instrumentation only fills the payload fields."""

    kind: ClassVar[str] = "event"

    t_mono: float = 0.0
    t_wall: float = 0.0
    step: Optional[int] = None
    rank: Optional[int] = None
    tid: Optional[int] = None
    trace: Optional[int] = None
    span: Optional[int] = None
    parent: Optional[int] = None

    def as_dict(self) -> Dict[str, Any]:
        """JSON-safe dict (``kind`` and ``schema`` included, tuples
        become lists)."""
        out: Dict[str, Any] = {"kind": self.kind, "schema": SCHEMA_VERSION}
        for f in dataclasses.fields(self):
            value = getattr(self, f.name)
            if isinstance(value, tuple):
                value = list(value)
            out[f.name] = value
        return out


@dataclass
class UpdateEvent(Event):
    """One ``Metric.update`` (or one fused ``toolkit.update_collection``
    dispatch covering ``fused`` metrics). ``seconds`` is the host time of
    the call: on the card, the time to enqueue its kernels (or replay its
    CUDA graph), not their device time."""

    kind: ClassVar[str] = "update"

    metric: str = ""
    seconds: float = 0.0
    fused: int = 1


@dataclass
class ComputeEvent(Event):
    """One ``Metric.compute`` (``seconds``: host time of the call, as for
    :class:`UpdateEvent`)."""

    kind: ClassVar[str] = "compute"

    metric: str = ""
    seconds: float = 0.0


@dataclass
class SyncEvent(Event):
    """One whole eager state sync (``toolkit.get_synced_metric*``).

    ``ranks``/``world_size``/``degraded``/``policy``/``reformed`` mirror
    the :class:`~torcheval_tpu_torch.resilience.SyncProvenance` attached to the
    synced metrics, field for field, under fault injection too.
    ``sent_bytes``/``recv_bytes``
    are the packed wire payload this rank shipped / the surviving ranks'
    payloads it received (``synclib.SyncedStates``).
    """

    kind: ClassVar[str] = "sync"

    ranks: Tuple[int, ...] = ()
    world_size: int = 0
    degraded: bool = False
    policy: str = "raise"
    reformed: bool = False
    sent_bytes: int = 0
    recv_bytes: int = 0
    metrics: int = 0
    seconds: float = 0.0
    # cross-rank flow ordinal (obs/trace.py next_flow_id): the N-th sync
    # issued from this thread — identical on every rank by lockstep, so
    # merged traces can link the same collective across ranks with zero
    # communication. 0 = no flow recorded.
    flow: int = 0
    # lossiest quantized-wire-ladder rung any metric in this sync rode
    # (wire.py: "exact" | "bf16" | "int8"); per-metric rungs ride each
    # metric's SyncProvenance.wire_tier. New OPTIONAL field — schema 1.
    wire_tier: str = "exact"


@dataclass
class RetryEvent(Event):
    """One resilience-layer lifecycle event (``ResilientGroup``): a retry
    cause (``timeout`` / ``transient`` / ``partial-gather``), a
    degradation outcome (``degraded-local`` / ``degraded-quorum`` /
    ``failed``), or a survivor re-formation (``reform``).

    ``flight`` carries the formatted flight-ring tail (``obs/flight.py``)
    on timeout/failure events while the flight recorder is on — *which*
    collective in the sequence stalled, not just that one did."""

    kind: ClassVar[str] = "retry"

    reason: str = ""
    attempt: int = 0
    policy: str = "raise"
    detail: str = ""
    flight: str = ""


@dataclass
class SnapshotEvent(Event):
    """One committed (or attempted) elastic snapshot generation on this
    rank (``elastic.ElasticSession``)."""

    kind: ClassVar[str] = "snapshot"

    generation: int = -1
    seconds: float = 0.0
    shard_bytes: int = 0
    async_writer: bool = False


@dataclass
class RestoreEvent(Event):
    """One successful ``ElasticSession.restore`` on this rank."""

    kind: ClassVar[str] = "restore"

    generation: int = -1
    restored_step: int = 0
    old_world: int = 0
    new_world: int = 0
    seconds: float = 0.0


@dataclass
class CompileEvent(Event):
    """One CUDA-graph capture of a bucketed update (bridged from
    ``utils.CompileCounter``'s event sink, fed by ``metrics/_fuse.py``).
    The JAX package's event of this kind is an XLA program demand; the
    port's nearest counterpart is a capture: ``seconds`` is the capture's
    host time, and ``cache_hit`` is always False (a capture is never
    served from a cache)."""

    kind: ClassVar[str] = "compile"

    seconds: float = 0.0
    cache_hit: bool = False
    # causal attribution (obs/trace.py): the innermost open span at the
    # moment of the capture -- e.g. "torcheval.update/MulticlassAccuracy"
    # names the metric family that demanded the graph -- and the shape
    # bucket length of the bucketed update that was captured
    site: str = ""
    bucket: int = 0


@dataclass
class SpanEvent(Event):
    """One user-named phase closed by ``Recorder.span`` (the phase also
    appears in ``torch.profiler`` traces via
    ``torch.profiler.record_function``)."""

    kind: ClassVar[str] = "span"

    name: str = ""
    seconds: float = 0.0


@dataclass
class MemoryEvent(Event):
    """One per-metric device-cost accounting snapshot
    (``obs.memory.memory_report``): the bytes this metric's registered
    state leaves pin in device memory, from a host-side metadata walk —
    no step executes, no device sync."""

    kind: ClassVar[str] = "memory"

    metric: str = ""
    state_bytes: int = 0
    states: int = 0
    # sharded-state accounting: what the state would cost
    # replicated vs what THIS rank/device actually pins. Equal on
    # replicated families; per_rank_bytes ~= logical/world on sharded.
    logical_bytes: int = 0
    per_rank_bytes: int = 0


@dataclass
class AnalysisEvent(Event):
    """One active static-analysis finding (the JAX package's
    ``torcheval_tpu.analysis``, not yet ported), mirrored from its
    ``Finding`` when an analyzer runs while the recorder is on — so a CI failure's event tail
    carries the forensics that explain it (which rule, where, why)."""

    kind: ClassVar[str] = "analysis"

    tool: str = ""
    rule: str = ""
    path: str = ""
    line: int = 0
    severity: str = "error"
    message: str = ""


@dataclass
class StallEvent(Event):
    """One stall-watchdog trip (``obs/watchdog.py``): a collective sat in
    the flight ring past the deadline with no flight progress anywhere in
    the process. Emitted (and dumped to stderr/JSONL) *before* the
    process dies or an operator kills it — the hang forensics record.

    ``op``/``seq`` identify the stuck collective on this thread's flight
    ring (``seq`` is the per-thread collective ordinal — comparable
    across ranks by lockstep); ``span_path`` is the innermost open span
    path of the stalled thread at trip time."""

    kind: ClassVar[str] = "stall"

    op: str = ""
    seq: int = 0
    age_seconds: float = 0.0
    deadline: float = 0.0
    span_path: str = ""
    detail: str = ""


@dataclass
class DriftEvent(Event):
    """One data-quality drift scoring of a watched input series
    (``obs/quality.py``), emitted per ``Monitor.check`` while the
    recorder is on: the post-freeze window size vs the frozen
    reference, the PSI / histogram-KS / Welch-z scores, and which
    bounds (if any) the scoring breached (comma-joined, ``""`` when
    in-bounds). Breaches additionally raise monitor ``AlertEvent``s
    (cooldown-guarded); this event is the continuous score record."""

    kind: ClassVar[str] = "drift"

    series: str = ""
    count: float = 0.0
    ref_count: float = 0.0
    psi: float = 0.0
    ks: float = 0.0
    z: float = 0.0
    breach: str = ""


@dataclass
class RegionSyncEvent(Event):
    """One inter-region federation link action (``federation.py``):
    a posted snapshot (``send-delta``/``send-full``), an applied merge
    (``merge``), an acknowledged epoch (``ack``), an idempotently
    discarded re-delivery (``duplicate``), an anti-entropy trigger
    (``resync``/``base-mismatch``/``crc-failure``), or a link
    state change (``partition``/``heal``).

    ``region``/``peer`` name the directed link; ``epoch`` is the
    message's epoch stamp, ``local_epoch`` this region's exchange round,
    ``peer_epoch`` the peer's highest merged epoch in the ledger after
    the action; ``nbytes`` the wire payload (delta or full);
    ``staleness_epochs`` the staleness that tripped a ``partition``."""

    kind: ClassVar[str] = "region_sync"

    region: str = ""
    peer: str = ""
    action: str = ""
    epoch: int = 0
    local_epoch: int = 0
    peer_epoch: int = 0
    nbytes: int = 0
    staleness_epochs: int = 0


@dataclass
class PlaneSyncEvent(Event):
    """One background sync-plane round (``syncplane.py``).

    ``version`` is the merged snapshot version the round produced,
    ``generation`` the publish generation it consumed;
    ``ranks``/``world_size``/``degraded``/``policy``/``reformed`` mirror
    the round's :class:`~torcheval_tpu_torch.resilience.SyncProvenance` (the
    round's inner eager sync additionally records its own
    :class:`SyncEvent` with wire-byte accounting). A FAILED round
    records ``error`` with version 0 — the plane keeps serving the
    previous snapshot."""

    kind: ClassVar[str] = "plane_sync"

    version: int = 0
    generation: int = 0
    ranks: Tuple[int, ...] = ()
    world_size: int = 0
    degraded: bool = False
    policy: str = "raise"
    reformed: bool = False
    metrics: int = 0
    seconds: float = 0.0
    error: str = ""


@dataclass
class AlertEvent(Event):
    """One SLO/anomaly monitor alert (``obs/monitor.py``): a streaming
    drift detection (``alert="drift"``, EWMA z-score over observed metric
    values or latency-digest quantiles), a threshold breach
    (``alert="threshold"``), or an error-budget burn
    (``alert="burn-rate"``). ``name`` is the SLO/series name; ``value``
    the observed quantity; ``bound`` the configured limit; ``z`` the
    z-score for drift alerts."""

    kind: ClassVar[str] = "alert"

    name: str = ""
    alert: str = ""
    value: float = 0.0
    bound: float = 0.0
    z: float = 0.0
    message: str = ""


@dataclass
class WireTierEvent(Event):
    """One quantized-wire-ladder fallback (the JAX package's ``wire.py``): a
    MEASURED drift-budget breach (``obs/quality.py`` ``DriftSpec``)
    stepped ``family``'s effective wire rung one rung toward exact
    (``prev_tier -> tier``, e.g. ``int8 -> bf16``). ``series`` names the
    watched input series whose scoring breached; ``breach`` the
    comma-joined breached bound kinds (``psi``/``ks``/``z``). Later
    syncs of the family ride the new rung until
    ``wire.LADDER.reset()`` lifts the cap (e.g. after a re-baseline)."""

    kind: ClassVar[str] = "wire_tier"

    family: str = ""
    series: str = ""
    prev_tier: str = ""
    tier: str = ""
    breach: str = ""


@dataclass
class AdmissionEvent(Event):
    """One admission-ladder rung transition (``table._admission``): the
    drain-time controller stepped ``prev_rung → rung`` on merged
    pressure. ``sampled_fraction`` is the NEW rung's admission
    probability; ``epoch`` the drain epoch at which it takes effect.
    Recorded once per transition per rank (transitions are computed on
    merged state, so every rank records the same step)."""

    kind: ClassVar[str] = "admission"

    table: str = ""
    prev_rung: int = 0
    rung: int = 0
    rung_name: str = "full"
    pressure: float = 0.0
    sampled_fraction: float = 1.0
    epoch: int = 0


@dataclass
class FailoverEvent(Event):
    """One phase of a ``failover.FailureDomain`` rank-loss recovery:
    ``action`` walks ``detected`` (loss confirmed from local signals) →
    ``reconstructed`` (dead ranks' partitioned state rebuilt over the
    survivors, loss bound declared) → ``reformed`` (every communicator
    re-formed to the survivor world) → ``rejoined`` (live re-entry at
    the full world, no process restart). ``world_size`` is the world the
    domain serves AFTER the phase; ``loss_steps``/``loss_epochs`` and
    the source ``generation`` mirror the declared ``LossBound``."""

    kind: ClassVar[str] = "failover"

    action: str = ""
    dead_ranks: Tuple[int, ...] = ()
    survivors: Tuple[int, ...] = ()
    world_size: int = 0
    generation: int = -1
    loss_steps: int = 0
    loss_epochs: int = 0
    seconds: float = 0.0


_EVENT_TYPES: Dict[str, Type[Event]] = {
    cls.kind: cls
    for cls in (
        AdmissionEvent,
        AlertEvent,
        DriftEvent,
        FailoverEvent,
        WireTierEvent,
        AnalysisEvent,
        MemoryEvent,
        PlaneSyncEvent,
        RegionSyncEvent,
        StallEvent,
        UpdateEvent,
        ComputeEvent,
        SyncEvent,
        RetryEvent,
        SnapshotEvent,
        RestoreEvent,
        CompileEvent,
        SpanEvent,
        Event,
    )
}


def event_from_dict(data: Dict[str, Any]) -> Event:
    """Inverse of :meth:`Event.as_dict` — the JSONL read side.

    Unknown keys are ignored (a newer writer's extra fields must not
    break an older reader); lists are restored to tuples (the only
    sequence type events use).
    """
    kind = data.get("kind", "event")
    cls = _EVENT_TYPES.get(kind, Event)
    names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {
        k: (tuple(v) if isinstance(v, list) else v)
        for k, v in data.items()
        if k in names
    }
    return cls(**kwargs)
