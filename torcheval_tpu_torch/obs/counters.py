"""Unified counter registry federating the stack's scattered counters.

Counterpart of ``torcheval_tpu/obs/counters.py``, with the same sources
and counter names. Each subsystem keeps its own record —
``utils.CompileCounter`` (CUDA-graph captures), ``resilience.SyncHealth``
/ ``default_sync_health()`` (sync attempts/retries/timeouts/
degradations), ``elastic.ElasticSession`` timings (snapshots) — and the
registry ABSORBS them behind one read API rather than replacing them:

    >>> from torcheval_tpu_torch import obs
    >>> reg = obs.default_registry()
    >>> reg.read()["sync"]["attempts"]     # == default_sync_health().attempts
    >>> reg.flat()["compile.programs"]     # one flat namespace for exporters

Sources are pull-based suppliers (zero cost until read), so registering a
source adds nothing to any hot path. The default registry federates:

- ``compile``: a process-wide always-active ``CompileCounter`` (installed
  on first registry access; it counts CUDA-graph captures, which are
  rare and expensive, so counting them costs nothing that matters);
- ``sync``: ``resilience.default_sync_health().as_dict()`` — the record
  every config-driven resilient sync already accumulates into;
- ``events``: the global recorder's per-kind event counts + ring stats;
- ``snapshots``: elastic snapshot/restore tallies (updated by
  ``elastic.ElasticSession`` whether or not the recorder is enabled —
  the snapshot path is not a hot path, and a restart diagnosis wants
  these even when event recording was off);
- ``flight``: the collective flight recorder's ring stats;
- ``admission``: the overload admission ladder over the live armed
  metric tables (``table._admission.armed_counter_source``: armed count,
  worst rung, lowest sampled fraction, admitted/shed row and transition
  totals);
- ``wire``: the quantized wire ladder (``wire.LADDER.counters()``: the
  configured default rung, the block size and every drift-breach cap);
- ``buffers``: the example buffers' growths and the bytes they copied
  (``metrics._buffer.growth_counts()``; counted whether or not the
  recorder is on). The port alone has this source.
- ``graphs``: the CUDA graphs of plan groups (``metrics._fuse.graph_stats()``:
  captures, replays, the unbucketed groups run eagerly by reason, graphs
  and pools alive). The port alone has this source too.
- ``moe``: the dropless top-k expert layer (``parallel.moe.moe_counts()``:
  model forwards, routed pairs counted from shapes, the pairs the grouped
  products computed (each held expert's rows between its offsets) and
  the busiest expert's load over the mean; counted whether or not the
  recorder is on, the loads on the device and read back only here). The
  port alone has this source.
  An armed sync plane adds ``syncplane``, an armed federation
  ``federation`` and an armed failure domain ``resilience`` while they
  are open.

``register``/``unregister`` let applications add their own sources; the
exporters (``render_prometheus``, ``format_report``,
``gather_observability``) read whatever the registry holds.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional

__all__ = ["CounterRegistry", "default_registry"]

# elastic snapshot/restore tallies (see module docstring for why these
# accumulate independently of the recorder's enabled flag)
_SNAPSHOT_STATS: Dict[str, Any] = {  # tev: guarded-by=_SNAPSHOT_LOCK
    "snapshots_written": 0,
    "snapshot_secs_total": 0.0,
    "last_snapshot_secs": 0.0,
    "last_generation": -1,
    "restores": 0,
    "restore_secs_total": 0.0,
}
_SNAPSHOT_LOCK = threading.Lock()


def note_snapshot(generation: int, seconds: float) -> None:
    """Called by ``elastic.ElasticSession`` after each written bundle."""
    with _SNAPSHOT_LOCK:
        _SNAPSHOT_STATS["snapshots_written"] += 1
        _SNAPSHOT_STATS["snapshot_secs_total"] += float(seconds)
        _SNAPSHOT_STATS["last_snapshot_secs"] = float(seconds)
        _SNAPSHOT_STATS["last_generation"] = int(generation)


def note_restore(seconds: float) -> None:
    """Called by ``elastic.ElasticSession`` after a successful restore."""
    with _SNAPSHOT_LOCK:
        _SNAPSHOT_STATS["restores"] += 1
        _SNAPSHOT_STATS["restore_secs_total"] += float(seconds)


def _snapshot_source() -> Dict[str, Any]:
    with _SNAPSHOT_LOCK:
        return dict(_SNAPSHOT_STATS)


def _sync_source() -> Dict[str, Any]:
    from torcheval_tpu_torch.resilience import default_sync_health

    return default_sync_health().as_dict()


def _flight_source() -> Dict[str, Any]:
    from torcheval_tpu_torch.obs.flight import FLIGHT

    return FLIGHT.counters()


def _admission_source() -> Dict[str, Any]:
    """The admission ladder's counters over the live armed metric tables
    (``table._admission.armed_counter_source``)."""
    from torcheval_tpu_torch.table._admission import armed_counter_source

    return armed_counter_source()


def _wire_source() -> Dict[str, Any]:
    from torcheval_tpu_torch.wire import LADDER

    return LADDER.counters()


def _buffers_source() -> Dict[str, Any]:
    from torcheval_tpu_torch.metrics._buffer import growth_counts

    return growth_counts()


def _graphs_source() -> Dict[str, Any]:
    from torcheval_tpu_torch.metrics._fuse import graph_stats

    return graph_stats()


def _moe_source() -> Dict[str, Any]:
    from torcheval_tpu_torch.parallel.moe import moe_counts

    return moe_counts()


def _events_source() -> Dict[str, Any]:
    from torcheval_tpu_torch.obs.recorder import RECORDER

    log = RECORDER.log
    out: Dict[str, Any] = {
        "enabled": int(RECORDER.enabled),
        "recorded_total": log.total,
        "retained": len(log),
        "dropped": log.dropped,
        "capacity": log.capacity,
    }
    for kind, count in sorted(log.counts.items()):
        out[f"kind_{kind}"] = count
    return out


class CounterRegistry:
    """Named pull-based counter sources behind one read API.

    A source is ``name -> supplier`` where ``supplier()`` returns a flat
    ``{counter: value}`` dict. Suppliers run only at read time
    (:meth:`read` / :meth:`flat`), so registration is free on every hot
    path. A supplier that raises is reported as
    ``{"error": "<message>"}`` instead of failing the whole read — one
    broken source must not take down an exporter scrape.
    """

    def __init__(self) -> None:
        self._sources: Dict[str, Callable[[], Dict[str, Any]]] = {}  # tev: guarded-by=_lock
        self._lock = threading.Lock()

    def register(
        self, name: str, supplier: Callable[[], Dict[str, Any]]
    ) -> None:
        with self._lock:
            self._sources[name] = supplier

    def unregister(self, name: str) -> None:
        with self._lock:
            self._sources.pop(name, None)

    @property
    def sources(self) -> tuple:
        with self._lock:
            return tuple(sorted(self._sources))

    def read(self) -> Dict[str, Dict[str, Any]]:
        """``{source: {counter: value}}``, sources in sorted order."""
        with self._lock:
            items = sorted(self._sources.items())
        out: Dict[str, Dict[str, Any]] = {}
        for name, supplier in items:
            try:
                out[name] = dict(supplier())
            except Exception as e:  # noqa: BLE001 — one source, not the scrape
                out[name] = {"error": f"{type(e).__name__}: {e}"}
        return out

    def flat(self) -> Dict[str, Any]:
        """One flat ``{"source.counter": value}`` namespace (exporters)."""
        return {
            f"{source}.{counter}": value
            for source, counters in self.read().items()
            for counter, value in counters.items()
        }


_DEFAULT: Optional[CounterRegistry] = None  # tev: guarded-by=_DEFAULT_LOCK
_GLOBAL_COMPILE = None  # tev: guarded-by=_DEFAULT_LOCK
_DEFAULT_LOCK = threading.Lock()


def default_registry() -> CounterRegistry:
    """The process-wide registry with the built-in sources (module
    docstring). Created lazily; the same instance is returned forever
    after, so application sources registered on it persist."""
    global _DEFAULT, _GLOBAL_COMPILE
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            from torcheval_tpu_torch.utils.compile_counter import CompileCounter

            _GLOBAL_COMPILE = CompileCounter()
            _GLOBAL_COMPILE.__enter__()  # active for the process lifetime
            compile_counter = _GLOBAL_COMPILE

            def _compile_source() -> Dict[str, Any]:
                return {
                    "programs": compile_counter.programs,
                    "compiles": compile_counter.compiles,
                    "cache_hits": compile_counter.cache_hits,
                    "compile_secs": compile_counter.compile_secs,
                }

            registry = CounterRegistry()
            registry.register("compile", _compile_source)
            registry.register("sync", _sync_source)
            registry.register("events", _events_source)
            registry.register("snapshots", _snapshot_source)
            # flight-recorder ring stats; the watchdog and
            # SLO monitor register "watchdog"/"slo" sources when armed
            registry.register("flight", _flight_source)
            # overload admission ladder across armed metric tables
            # (worst rung wins; zeros while nothing is armed)
            registry.register("admission", _admission_source)
            # quantized wire ladder: configured rung + drift-breach caps
            registry.register("wire", _wire_source)
            # example-buffer growths and the bytes they copied
            registry.register("buffers", _buffers_source)
            # CUDA-graph captures, replays and eager groups by reason
            registry.register("graphs", _graphs_source)
            # routed pairs and expert loads of the dropless top-k layer
            registry.register("moe", _moe_source)
            _DEFAULT = registry
        return _DEFAULT
