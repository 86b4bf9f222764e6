"""Unified observability for the eval stack.

Counterpart of ``torcheval_tpu/obs/``, with the same public names, event
schema, Prometheus families and ``/healthz`` layout. Each subsystem's
signal has one home here:

- **Events** (:mod:`~torcheval_tpu_torch.obs.events`): typed lifecycle
  records — ``UpdateEvent``/``ComputeEvent`` (metric core), ``SyncEvent``
  (provenance + wire bytes), ``RetryEvent`` (resilience retries,
  degradations, re-formations), ``SnapshotEvent``/``RestoreEvent``
  (elastic), ``CompileEvent`` (a CUDA-graph capture), ``SpanEvent`` (user
  phases) — stamped with monotonic + wall time and the step cursor.
- **Recorder** (:mod:`~torcheval_tpu_torch.obs.recorder`): the
  process-global sink. OFF by default and near-zero-cost when off —
  every instrumented site guards on one attribute read; recording adds
  no host sync, no device allocation and no collective to any step path.
  ``span()`` phases also land in ``torch.profiler`` traces through
  ``torch.profiler.record_function``.
- **Tracing, flight recorder, watchdog** (``trace``, ``flight``,
  ``watchdog``): span trees with cross-rank flow ids, per-thread rings of
  in-flight collectives, and a stall watchdog that dumps them.
- **Counters, digests, monitor** (``counters``, ``hist``, ``monitor``,
  ``memory``): one registry over the scattered counters, log2 latency
  digests, SLO and drift alerts, state-byte accounting.
- **Exporters and the health server** (``export``, ``server``): async
  JSONL writer, ``render_prometheus()``, ``format_report()``, Chrome
  traces, the cross-rank gathers, and ``/metrics``, ``/healthz``,
  ``/flight``, ``/report`` over HTTP.

- **Data quality** (``sketch``, ``quality``): mergeable input sketches
  (``InputSketch``) and ``watch_inputs``, which folds them into a watched
  metric's own update, with drift scoring against a frozen reference
  (``DriftSpec``). These names load lazily: the modules import the metric
  core, which imports this package.

Enable with ``config.observability(...)``, ``obs.enable()``, or env
``TORCHEVAL_TPU_OBSERVABILITY=1`` (a ``*.jsonl`` value also attaches the
line writer)::

    >>> from torcheval_tpu_torch import config, obs
    >>> with config.observability(jsonl="/tmp/eval-events.jsonl"):
    ...     for step, batch in enumerate(loader):
    ...         obs.recorder().set_step(step)
    ...         update_collection(metrics, *batch)
    >>> print(obs.format_report())
"""

from torcheval_tpu_torch.obs.counters import CounterRegistry, default_registry
from torcheval_tpu_torch.obs.events import (
    SCHEMA_VERSION,
    AlertEvent,
    AnalysisEvent,
    CompileEvent,
    ComputeEvent,
    DriftEvent,
    Event,
    FailoverEvent,
    MemoryEvent,
    PlaneSyncEvent,
    RegionSyncEvent,
    RestoreEvent,
    RetryEvent,
    SnapshotEvent,
    SpanEvent,
    StallEvent,
    SyncEvent,
    UpdateEvent,
    WireTierEvent,
    event_from_dict,
)
from torcheval_tpu_torch.obs.flight import (
    FLIGHT,
    FlightDiff,
    FlightRecord,
    FlightRecorder,
    diff_flight_rings,
    format_flight,
    gather_flight,
)
from torcheval_tpu_torch.obs.monitor import (
    EwmaStat,
    Monitor,
    SloSpec,
    arm_monitor,
    current_monitor,
    disarm_monitor,
    register_check_hook,
    unregister_check_hook,
)
# The data-quality layer (obs/sketch.py, obs/quality.py), loaded lazily:
# both import the metric core, which imports this package.
_LAZY_QUALITY = {
    "QUALITY": "quality",
    "DriftSpec": "quality",
    "QualityWatch": "quality",
    "active_watches": "quality",
    "watch_inputs": "quality",
    "InputSketch": "sketch",
    "SketchConfig": "sketch",
    "SketchSummary": "sketch",
    "chan_merge": "sketch",
    "hll_estimate": "sketch",
}


def __getattr__(name):
    module = _LAZY_QUALITY.get(name)
    if module is None:
        raise AttributeError(
            f"module 'torcheval_tpu_torch.obs' has no attribute {name!r}"
        )
    import importlib

    return getattr(importlib.import_module(f"torcheval_tpu_torch.obs.{module}"), name)


from torcheval_tpu_torch.obs.server import (
    ObsServer,
    current_server,
    healthz_payload,
    start_server,
    stop_server,
)
from torcheval_tpu_torch.obs.watchdog import (
    StallWatchdog,
    arm_watchdog,
    current_watchdog,
    disarm_watchdog,
)
from torcheval_tpu_torch.obs.export import (
    JsonlWriter,
    export_chrome_trace,
    format_report,
    gather_observability,
    gather_traces,
    read_jsonl,
    render_prometheus,
)
from torcheval_tpu_torch.obs.hist import LatencyHistogram
from torcheval_tpu_torch.obs.hist import snapshot as latency_snapshot
from torcheval_tpu_torch.obs.memory import (
    logical_state_bytes,
    memory_report,
    metric_update_costs,
    per_rank_state_bytes,
    program_costs,
    state_bytes,
    track_metrics,
)
from torcheval_tpu_torch.obs.recorder import (
    RECORDER,
    EventLog,
    Recorder,
    disable,
    enable,
    enabled,
    recorder,
    span,
)
from torcheval_tpu_torch.obs.trace import trace_path

__all__ = [
    "AlertEvent",
    "AnalysisEvent",
    "CompileEvent",
    "ComputeEvent",
    "CounterRegistry",
    "DriftEvent",
    "DriftSpec",
    "Event",
    "EventLog",
    "EwmaStat",
    "FLIGHT",
    "FailoverEvent",
    "FlightDiff",
    "FlightRecord",
    "FlightRecorder",
    "InputSketch",
    "JsonlWriter",
    "LatencyHistogram",
    "MemoryEvent",
    "Monitor",
    "ObsServer",
    "PlaneSyncEvent",
    "QUALITY",
    "QualityWatch",
    "Recorder",
    "RegionSyncEvent",
    "RestoreEvent",
    "RetryEvent",
    "SCHEMA_VERSION",
    "SketchConfig",
    "SketchSummary",
    "SloSpec",
    "SnapshotEvent",
    "SpanEvent",
    "StallEvent",
    "StallWatchdog",
    "SyncEvent",
    "UpdateEvent",
    "WireTierEvent",
    "active_watches",
    "arm_monitor",
    "arm_watchdog",
    "chan_merge",
    "current_monitor",
    "current_server",
    "current_watchdog",
    "default_registry",
    "diff_flight_rings",
    "disable",
    "disarm_monitor",
    "disarm_watchdog",
    "enable",
    "enabled",
    "event_from_dict",
    "export_chrome_trace",
    "format_flight",
    "format_report",
    "gather_flight",
    "gather_observability",
    "gather_traces",
    "healthz_payload",
    "hll_estimate",
    "latency_snapshot",
    "logical_state_bytes",
    "memory_report",
    "metric_update_costs",
    "per_rank_state_bytes",
    "program_costs",
    "read_jsonl",
    "recorder",
    "register_check_hook",
    "render_prometheus",
    "span",
    "start_server",
    "state_bytes",
    "stop_server",
    "trace_path",
    "track_metrics",
    "unregister_check_hook",
    "watch_inputs",
]
