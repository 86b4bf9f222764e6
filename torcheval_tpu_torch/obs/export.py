"""Exporters: JSONL event stream, Prometheus exposition, human report,
Chrome/Perfetto traces, and the cross-rank gathers.

Counterpart of ``torcheval_tpu/obs/export.py``: the same JSONL lines, the
same Prometheus family names (prefix ``torcheval_tpu``) and the same
Chrome trace layout, so dashboards and readers built for one package read
the other, including the data-quality sections (the ``quality_value``
histograms and the report's ``[quality]`` table, from the armed
``obs/quality.py`` watches). Apart from those sketch readbacks, which are
scrape-cadence by design, every number exported is host data.

Ways out of the recorder/registry, matched to their consumers:

- :class:`JsonlWriter` — an async bounded-queue line writer for log
  shippers (one JSON object per event, ``events.event_from_dict`` reads
  them back). Same background-writer discipline as the elastic snapshot
  writer it is modeled on: a daemon thread does the I/O, ``write`` blocks
  only when the queue is full (backpressure, never silent drops), errors
  are ferried to the caller and re-raised at ``drain``/``close``, and
  ``close`` drains cleanly.
- :func:`render_prometheus` — a text-exposition snapshot of the counter
  registry (label values escaped, names sanitized) PLUS the latency
  digests as proper ``# TYPE ... histogram`` families with cumulative
  ``_bucket`` / ``_sum`` / ``_count`` series.
- :func:`format_report` — a human-readable table (counters + latency
  p50/p99 + recent events) for terminals and bug reports; the
  failure-dump pytest hook in ``conftest.py`` prints this.
- :func:`export_chrome_trace` — the recorded events as Chrome
  trace-event JSON, loadable in Perfetto / ``chrome://tracing``:
  per-rank process lanes, per-thread tracks, complete ``X`` slices for
  duration events, instants for point events, and flow arrows linking
  the same sync across ranks (via ``SyncEvent.flow``).
- :func:`gather_observability` / :func:`gather_traces` — ONE collective
  each over a ``ProcessGroup`` merging every rank's counters+events
  (respectively events+latency digests) into a single report, so the
  leader can answer "which rank stalled which sync?" without ssh'ing
  around. Rides the existing group machinery (``allgather_object``), so
  it works over ``MultiHostGroup``, subgroups, ``ResilientGroup``
  wrappers, and the in-process ``ThreadWorld`` test world alike.
"""

from __future__ import annotations

import json
import re
import threading
import time
from typing import Any, Dict, List, Optional, Union

from torcheval_tpu_torch.obs import hist as _hist
from torcheval_tpu_torch.obs.events import Event, event_from_dict
from torcheval_tpu_torch.obs.recorder import RECORDER, EventLog

__all__ = [
    "JsonlWriter",
    "export_chrome_trace",
    "format_report",
    "gather_observability",
    "gather_traces",
    "read_jsonl",
    "render_prometheus",
]


class JsonlWriter:
    """Append events to ``path`` as JSON lines, off the caller's thread.

    ``write`` appends to a bounded in-memory batch (blocking only when
    ``depth`` events are already pending — the backpressure contract;
    never a silent drop); a daemon thread wakes every
    ``flush_interval`` seconds, swaps the whole batch out, and
    serializes + appends it in one write. Batched hand-off, not a
    per-event queue: waking the writer on every event would put a
    GIL/context switch on the step path, while an append under a lock is
    sub-microsecond — the step path must not pay for telemetry I/O.

    I/O errors never surface inside ``write`` (an eval step must not die
    because a log disk filled) — they are ferried and re-raised at
    :meth:`drain` / :meth:`close`, after which the writer is inert.
    ``close`` drains, stops the thread, and closes the file.
    """

    def __init__(
        self, path: str, *, depth: int = 4096, flush_interval: float = 0.05
    ) -> None:
        self.path = path
        self.depth = int(depth)
        self.flush_interval = float(flush_interval)
        self.error: Optional[BaseException] = None  # tev: disable=unguarded-state -- single-writer error ferry: only the writer thread sets it, the caller reads/clears it at drain/close; a reference swap is atomic under the GIL
        self._lock = threading.Lock()
        self._buf: List[dict] = []  # tev: guarded-by=_lock
        self._writing = False  # tev: guarded-by=_lock
        self._stop = False  # tev: guarded-by=_lock
        self._closed = False  # tev: disable=unguarded-state -- caller-thread-only lifecycle flag (close() is caller API; the writer thread never reads it)
        self._kick = threading.Event()  # "flush now" (drain/backpressure)
        # open on the caller's thread so a bad path fails at construction,
        # not silently inside the daemon
        self._f = open(path, "a", encoding="utf-8")
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="torcheval-obs-jsonl"
        )
        self._thread.start()

    def _loop(self) -> None:  # tev: scope=writer
        while True:
            self._kick.wait(self.flush_interval)
            self._kick.clear()
            with self._lock:
                batch, self._buf = self._buf, []
                self._writing = bool(batch)
                stop = self._stop
            if batch and self.error is None:
                try:
                    self._f.write(
                        "".join(json.dumps(d) + "\n" for d in batch)
                    )
                    self._f.flush()
                except Exception as e:  # noqa: BLE001 — ferried
                    if self.error is None:
                        self.error = e
            with self._lock:
                self._writing = False
                if stop and not self._buf:
                    return

    def write(self, event: Event) -> None:
        """Buffer one event (never raises; see class docstring)."""
        if self._closed or self.error is not None:
            return
        payload = event.as_dict()
        while True:
            with self._lock:
                if len(self._buf) < self.depth or self.error is not None:
                    self._buf.append(payload)
                    return
            # backpressure: the writer is behind — flush now and wait
            self._kick.set()
            time.sleep(0.001)

    def _idle(self) -> bool:
        with self._lock:
            return not self._buf and not self._writing

    def drain(self) -> None:
        """Block until every buffered event is on disk (flushed);
        re-raise any ferried writer error."""
        while not self._idle() and self.error is None:
            self._kick.set()
            time.sleep(0.002)
        if self.error is not None:
            error, self.error = self.error, None
            raise error

    def close(self) -> None:
        """Drain, stop the writer thread, close the file; re-raise any
        ferried error (after the file is closed)."""
        if self._closed:
            return
        try:
            self.drain()
        finally:
            self._closed = True
            with self._lock:
                self._stop = True
            self._kick.set()
            self._thread.join(timeout=30.0)
            try:
                self._f.close()
            except Exception:  # noqa: BLE001 — best-effort on teardown
                pass


def read_jsonl(path: str) -> List[Event]:
    """Read a :class:`JsonlWriter` file back into typed events (the
    round-trip contract: ``read_jsonl(p) == the events written``)."""
    out: List[Event] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(event_from_dict(json.loads(line)))
    return out


_PROM_NAME = re.compile(r"[^a-zA-Z0-9_]")

# counters that only ever move up -> `counter`; everything else `gauge`
_PROM_COUNTER_HINTS = (
    "attempts", "retries", "timeouts", "errors", "gathers", "payloads",
    "syncs", "reforms", "programs", "compiles", "hits", "written", "total",
    "restores", "kind_", "recorded", "trips",
)


def _prom_name(raw: str) -> str:
    """Sanitize to the Prometheus metric-name grammar
    (``[a-zA-Z_][a-zA-Z0-9_]*``): every forbidden character becomes
    ``_``, and a leading digit gets a ``_`` prefix — a counter key like
    ``update/MulticlassAccuracy`` or ``99p`` must never emit an
    unparseable exposition line."""
    name = _PROM_NAME.sub("_", raw)
    if not name or name[0].isdigit():
        name = "_" + name
    return name


def _prom_label_value(value: Any) -> str:
    """Escape a label VALUE per the exposition format: backslash, double
    quote, and newline are the three characters the grammar requires
    escaped (in that order — escaping the escapes first)."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _prom_le(upper_us: float) -> str:
    """A bucket's ``le`` label value in SECONDS (``+Inf`` for the last)."""
    if upper_us == float("inf"):
        return "+Inf"
    return format(upper_us / 1e6, ".12g")


def _render_histograms(histograms, prefix: str) -> List[str]:
    """The latency digests as Prometheus ``histogram`` families:
    cumulative ``_bucket{le=...}`` series plus ``_sum``/``_count``, one
    labeled series set per digest key (``op=<key>``)."""
    family = _prom_name(f"{prefix}_latency_seconds")
    lines: List[str] = []
    if histograms:
        lines.append(f"# TYPE {family} histogram")
    bounds = _hist.bucket_upper_bounds_us()
    for key in sorted(histograms):
        h = histograms[key]
        op = _prom_label_value(key)
        cumulative = 0
        for upper, count in zip(bounds, h.counts):
            cumulative += count
            lines.append(
                f'{family}_bucket{{op="{op}",le="{_prom_le(upper)}"}} '
                f"{cumulative}"
            )
        lines.append(f'{family}_sum{{op="{op}"}} {h.sum}')
        lines.append(f'{family}_count{{op="{op}"}} {h.count}')
    return lines


def _render_quality_histograms(prefix: str) -> List[str]:
    """The armed quality watches' value sketches as Prometheus
    ``histogram`` families: one labelled series set a watched input
    (``input=<series>``), cumulative ``_bucket{le=<edge>}`` over the
    sketch's value-space edges with the below-range lane in every bucket,
    and ``+Inf`` covering below + bins + above (NaN/Inf ride the
    ``quality`` gauges). ``_sum`` is mean x count of the finite samples,
    from the streaming moments. Reads the small sketch states back:
    scrape cadence, never the step path."""
    from torcheval_tpu_torch.obs import quality as _quality
    from torcheval_tpu_torch.obs.sketch import _CNT_ABOVE, _CNT_BELOW

    watches = _quality.active_watches()
    if not watches:
        return []
    family = _prom_name(f"{prefix}_quality_value")
    lines: List[str] = [f"# TYPE {family} histogram"]
    emitted = False
    for watch in watches:
        edges = watch.config.edges()
        for series in watch.series:
            states = watch._states(series)
            label = _prom_label_value(series)
            below = float(states["cnt"][_CNT_BELOW])
            above = float(states["cnt"][_CNT_ABOVE])
            cumulative = below
            for edge, count in zip(edges[1:], states["hist"]):
                cumulative += float(count)
                lines.append(
                    f'{family}_bucket{{input="{label}",'
                    f'le="{format(float(edge), ".9g")}"}} '
                    f"{format(cumulative, '.12g')}"
                )
            total = cumulative + above
            lines.append(f'{family}_bucket{{input="{label}",le="+Inf"}} {format(total, ".12g")}')
            mom = states["mom"]
            lines.append(f'{family}_sum{{input="{label}"}} {float(mom[0]) * float(mom[1])}')
            lines.append(f'{family}_count{{input="{label}"}} {format(total, ".12g")}')
            emitted = True
    return lines if emitted else []


def render_prometheus(
    registry=None,
    *,
    prefix: str = "torcheval_tpu",
    histograms: Optional[Dict[str, "_hist.LatencyHistogram"]] = None,
) -> str:
    """Prometheus text-exposition snapshot of a counter registry
    (default: ``counters.default_registry()``) plus the latency digests
    (default: the process-global ``obs.hist`` registry; pass ``{}`` to
    suppress).

    Numeric counters only — strings, rank lists, and None values are
    skipped (Prometheus has no representation for them; they remain
    available via :func:`format_report` and the JSONL stream). Booleans
    export as 0/1 gauges. Names are sanitized to the exposition grammar
    and label values escaped (backslash/quote/newline) — every emitted
    line parses.
    """
    from torcheval_tpu_torch.obs.counters import default_registry

    if registry is None:
        registry = default_registry()
    if histograms is None:
        histograms = _hist.snapshot()
    lines: List[str] = []
    for source, counters in sorted(registry.read().items()):
        for counter, value in sorted(counters.items()):
            if isinstance(value, bool):
                value = int(value)
                kind = "gauge"
            elif isinstance(value, (int, float)):
                kind = (
                    "counter"
                    if any(h in counter for h in _PROM_COUNTER_HINTS)
                    else "gauge"
                )
            else:
                continue
            name = _prom_name(f"{prefix}_{source}_{counter}")
            lines.append(f"# TYPE {name} {kind}")
            lines.append(f"{name} {value}")
    lines.extend(_render_histograms(histograms, prefix))
    lines.extend(_render_quality_histograms(prefix))
    return "\n".join(lines) + "\n"


def format_report(
    registry=None,
    log: Optional[EventLog] = None,
    *,
    tail: int = 20,
    histograms: Optional[Dict[str, "_hist.LatencyHistogram"]] = None,
) -> str:
    """Human-readable observability report: one counter table per
    source, the latency digests (count / mean / approximate p50 / p99
    per key), then the newest ``tail`` events (oldest-first)."""
    from torcheval_tpu_torch.obs.counters import default_registry

    if registry is None:
        registry = default_registry()
    if log is None:
        log = RECORDER.log
    if histograms is None:
        histograms = _hist.snapshot()
    lines: List[str] = ["torcheval_tpu observability report", "=" * 34]
    for source, counters in sorted(registry.read().items()):
        lines.append(f"\n[{source}]")
        width = max((len(k) for k in counters), default=0)
        for counter, value in sorted(counters.items()):
            lines.append(f"  {counter:<{width}}  {value}")
    if histograms:
        lines.append("\n[latency] (approximate quantiles, log2 buckets)")
        width = max(len(k) for k in histograms)
        for key in sorted(histograms):
            h = histograms[key]
            if not h.count:
                continue
            mean_us = h.sum / h.count * 1e6
            p50 = (h.quantile(0.5) or 0.0) * 1e6
            p99 = (h.quantile(0.99) or 0.0) * 1e6
            lines.append(
                f"  {key:<{width}}  n={h.count}  mean={mean_us:.1f}us"
                f"  p50<={p50:.1f}us  p99<={p99:.1f}us"
            )
    lines.extend(_quality_report_lines())
    events = log.tail(tail)
    lines.append(f"\n[events] newest {len(events)} of {log.total} recorded")
    for ev in events:
        payload = {
            k: v
            for k, v in ev.as_dict().items()
            if k not in ("kind", "schema", "t_mono", "t_wall", "tid", "trace")
            and v not in (None, "")
        }
        fields = " ".join(f"{k}={v}" for k, v in payload.items())
        lines.append(f"  {ev.t_mono:14.3f}  {ev.kind:<9} {fields}")
    return "\n".join(lines) + "\n"


def _quality_report_lines() -> List[str]:
    """The ``format_report`` input-quality table: a line a watched input
    with count, mean±std, range, conservative p50/p99, NaN/zero tallies
    and the distinct estimate, and the last drift scores. Empty when
    nothing is watched. Reads the sketch states back (scrape cadence)."""
    import math as _math

    from torcheval_tpu_torch.obs import quality as _quality

    watches = _quality.active_watches()
    if not watches:
        return []
    lines = ["\n[quality] (input sketches; p50/p99 conservative bin edges)"]
    for watch in watches:
        for series in watch.series:
            sk = watch.sketch(series)
            summary = sk.compute()
            std = _math.sqrt(summary.var) if summary.count else 0.0
            p50 = sk.quantile(0.5)
            p99 = sk.quantile(0.99)
            q = f"p50<={p50:.4g} p99<={p99:.4g}" if p50 is not None else "p50/p99=n/a"
            lines.append(
                f"  {series}  n={summary.count:.0f}"
                f"  mean={summary.mean:.4g}±{std:.4g}"
                f"  range=[{summary.min:.4g}, {summary.max:.4g}]  {q}"
                f"  nan={summary.nan} inf={summary.posinf + summary.neginf}"
                f" zero={summary.zero} neg={summary.negative}"
                f"  distinct~{summary.distinct:.0f}"
            )
            with watch._lock:
                scores = watch._scores.get(series)
            if scores:
                lines.append(
                    f"    drift: psi={scores['psi']:.4g}"
                    f" ks={scores['ks']:.4g} z={scores['z']:.4g}"
                    f" (window n={scores['count']:.0f}"
                    f" vs ref n={scores['ref_count']:.0f})"
                )
    return lines


def _check_rank_scoped(group, what: str) -> Optional[Dict[str, Any]]:
    """Shared entry checks for the cross-rank gathers: reject groups
    without per-rank observability state, and short-circuit non-members
    (they issue no collective). Returns the non-member result, or None
    when the caller should proceed with the gather."""
    from torcheval_tpu_torch.distributed import LocalReplicaGroup

    if isinstance(group.unwrap(), LocalReplicaGroup):
        raise TypeError(
            f"{what} needs a rank-per-process group; a "
            "LocalReplicaGroup's replicas share one process-global "
            "recorder — read it directly with format_report()"
        )
    if not group.is_member:
        return {
            "world_size": group.world_size,
            "ranks": [],
            "per_rank": {},
        }
    return None


def _rank_events(me: int, tail: int) -> List[Dict[str, Any]]:
    """This rank's contribution to a gather: the newest ``tail`` events
    that are THIS rank's (events whose ``rank`` field is this rank, or
    rank-less process-local events), as plain dicts."""
    return [
        ev.as_dict()
        for ev in RECORDER.log.tail(tail)
        if ev.rank is None or ev.rank == me
    ]


def gather_observability(
    group,
    *,
    registry=None,
    tail: int = 50,
) -> Dict[str, Any]:
    """Merge every rank's observability summary through ``group``.

    Every member rank calls this in step (it issues ONE
    ``allgather_object`` on ``group`` — never on the metric-sync path);
    each contributes its counter-registry snapshot plus the newest
    ``tail`` events that are THIS rank's (events whose ``rank`` field is
    this rank, or rank-less process-local events). All members receive
    the same merged report; rank 0 conventionally prints or ships it.

    Returns ``{"world_size", "ranks", "per_rank": {rank: {"counters",
    "events"}}}`` — events as plain dicts (``event_from_dict`` restores
    them). Requires a rank-per-process group (``MultiHostGroup``,
    ``ThreadWorld`` views, subgroups); a ``LocalReplicaGroup`` has no
    per-rank observability state to gather.
    """
    from torcheval_tpu_torch.obs.counters import default_registry

    non_member = _check_rank_scoped(group, "gather_observability")
    if non_member is not None:
        return non_member
    if registry is None:
        registry = default_registry()
    me = group.rank
    contribution = {
        "rank": me,
        "counters": registry.read(),
        "events": _rank_events(me, tail),
    }
    gathered = group.allgather_object(contribution)
    per_rank = {int(c["rank"]): c for c in gathered}
    return {
        "world_size": group.world_size,
        "ranks": sorted(per_rank),
        "per_rank": {
            r: {"counters": c["counters"], "events": c["events"]}
            for r, c in sorted(per_rank.items())
        },
    }


def gather_traces(
    group,
    *,
    tail: int = 200,
) -> Dict[str, Any]:
    """Merge every rank's trace events AND latency digests through
    ``group`` in ONE ``allgather_object`` (the ``gather_observability``
    discipline: every member calls it in step, never on the metric-sync
    path; works over ``MultiHostGroup``, ``ThreadWorld`` views,
    subgroups, and ``ResilientGroup`` wrappers).

    Returns ``{"world_size", "ranks", "per_rank": {rank: {"events":
    [...], "hist": {key: snapshot}}}, "latency": {key:
    LatencyHistogram}}`` — ``latency`` is the cross-rank merge of every
    rank's digests, folded in ascending rank order, so every member
    computes the same bits (the histogram merge-oracle property). Feed
    the whole result to :func:`export_chrome_trace` for a merged
    Perfetto timeline with per-rank lanes and cross-rank sync flows.
    """
    non_member = _check_rank_scoped(group, "gather_traces")
    if non_member is not None:
        non_member["latency"] = {}
        return non_member
    me = group.rank
    contribution = {
        "rank": me,
        "events": _rank_events(me, tail),
        "hist": {k: h.as_dict() for k, h in _hist.snapshot().items()},
    }
    gathered = group.allgather_object(contribution)
    per_rank = {int(c["rank"]): c for c in gathered}
    merged: Dict[str, _hist.LatencyHistogram] = {}
    for rank in sorted(per_rank):  # fixed fold order -> bit-identical
        for key, snap in sorted(per_rank[rank]["hist"].items()):
            h = _hist.LatencyHistogram.from_dict(snap)
            if key in merged:
                merged[key].merge(h)
            else:
                merged[key] = h
    return {
        "world_size": group.world_size,
        "ranks": sorted(per_rank),
        "per_rank": {
            r: {"events": c["events"], "hist": c["hist"]}
            for r, c in sorted(per_rank.items())
        },
        "latency": merged,
    }


# ------------------------------------------------------------ chrome trace

# kinds whose `seconds` is a true duration: they become complete "X"
# slices spanning [t_mono - seconds, t_mono]; everything else is an
# instant ("i") at t_mono
_DURATION_KINDS = frozenset(
    {"update", "compute", "sync", "snapshot", "restore", "span", "compile"}
)
_ENVELOPE_KEYS = frozenset(
    {"kind", "schema", "t_mono", "t_wall", "tid", "rank"}
)


def _chrome_label(d: Dict[str, Any]) -> str:
    kind = d.get("kind", "event")
    for key in ("metric", "name", "reason", "rule"):
        value = d.get(key)
        if value:
            return f"{kind}/{value}"
    if kind == "compile" and d.get("site"):
        return f"compile @ {d['site']}"
    return kind


def export_chrome_trace(
    events: Union[None, List[Any], Dict[str, Any]] = None,
    *,
    path: Optional[str] = None,
) -> Dict[str, Any]:
    """The event stream as Chrome trace-event JSON (Perfetto /
    ``chrome://tracing`` / ``ui.perfetto.dev`` all load it).

    ``events`` may be a list of :class:`~torcheval_tpu_torch.obs.events.Event`
    (or their dicts) — default: the global recorder's retained ring — or
    a :func:`gather_traces` result for a merged multi-rank timeline.

    Layout: one PROCESS lane per rank (``pid`` = rank; rank-less
    process-local events land in lane 0 unless the event carries a
    rank), one TRACK per emitting thread (``tid``), complete ``X``
    slices for duration events (update/compute/sync/snapshot/restore/
    span/compile — ``ts`` = start, ``dur`` = seconds), instants
    (``ph="i"``) for point events (retry/memory/analysis), and flow
    arrows (``ph`` s/t/f sharing ``id``) binding the SAME sync's slices
    across every contributing rank via ``SyncEvent.flow``. Payload
    fields ride in ``args``; span/parent ids ride there too, so a
    Perfetto query can rebuild the causal tree.

    Timestamps are wall-clock µs since the epoch (each event's
    ``t_wall``; its ``t_mono`` where an event has none): the clock a
    ``torch.profiler`` chrome trace uses (its ``ts`` plus
    ``baseTimeNanoseconds``), so a program trace and a profiler trace of
    the same run overlay, and a device trace's idle gap can be put down
    to the program span the host was in. Across hosts the lanes align as
    far as the hosts' clocks agree; flows link them either way.

    Returns the ``{"traceEvents": [...]}`` dict; ``path`` additionally
    writes it as JSON (every record carries ``ph``/``ts``/``pid``/``tid``;
    duration events are complete ``X`` slices).
    """
    if events is None:
        events = RECORDER.log.tail()
    if isinstance(events, dict) and "per_rank" in events:
        per_rank = {
            int(rank): list(contrib["events"])
            for rank, contrib in events["per_rank"].items()
        }
    else:
        per_rank = {}
        for ev in events:
            d = ev if isinstance(ev, dict) else ev.as_dict()
            rank = d.get("rank")
            per_rank.setdefault(0 if rank is None else int(rank), []).append(d)

    trace_events: List[Dict[str, Any]] = []
    # flow id -> [(pid, tid, ts_us_midslice)] of the sync slices sharing it
    flows: Dict[int, List] = {}
    for rank in sorted(per_rank):
        trace_events.append(
            {
                "ph": "M", "name": "process_name", "pid": rank, "tid": 0,
                "ts": 0, "args": {"name": f"rank {rank}"},
            }
        )
        for raw in per_rank[rank]:
            d = raw if isinstance(raw, dict) else raw.as_dict()
            kind = d.get("kind", "event")
            tid = d.get("tid") or 0
            t_end_us = float(d.get("t_wall") or d.get("t_mono", 0.0)) * 1e6
            args = {
                k: v
                for k, v in d.items()
                if k not in _ENVELOPE_KEYS and v is not None
            }
            record: Dict[str, Any] = {
                "name": _chrome_label(d),
                "cat": kind,
                "pid": rank,
                "tid": tid,
                "args": args,
            }
            if kind in _DURATION_KINDS:
                dur_us = max(float(d.get("seconds", 0.0)), 0.0) * 1e6
                record.update(
                    ph="X", ts=t_end_us - dur_us, dur=dur_us
                )
                if kind == "sync" and d.get("flow"):
                    flows.setdefault(int(d["flow"]), []).append(
                        (rank, tid, t_end_us - dur_us / 2)
                    )
            else:
                record.update(ph="i", ts=t_end_us, s="t")
            trace_events.append(record)
    # flow arrows: one start ("s") on the earliest slice, steps ("t")
    # through the middles, a finish ("f") on the latest — only when the
    # flow actually spans more than one slice. Ordered by TIMESTAMP, not
    # rank: the trace-event contract binds same-id flow events in ts
    # order, and a rank-major sequence whose ts runs backwards (rank 1
    # entered the sync first) makes Perfetto drop or mis-bind the arrow.
    for flow_id, slices in sorted(flows.items()):
        if len(slices) < 2:
            continue
        slices.sort(key=lambda s: (s[2], s[0], s[1]))
        for i, (pid, tid, ts) in enumerate(slices):
            ph = "s" if i == 0 else ("f" if i == len(slices) - 1 else "t")
            record = {
                "ph": ph, "name": "sync", "cat": "sync-flow",
                "id": flow_id, "pid": pid, "tid": tid, "ts": ts,
            }
            if ph == "f":
                record["bp"] = "e"
            trace_events.append(record)
    out = {"traceEvents": trace_events, "displayTimeUnit": "ms"}
    if path is not None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(out, f)
    return out
