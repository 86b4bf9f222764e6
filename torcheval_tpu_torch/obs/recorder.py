"""The global event recorder: off by default, near-zero-cost when off.

Counterpart of ``torcheval_tpu/obs/recorder.py``. The contract that makes instrumentation safe to leave in the hot paths
(``Metric.update``/``compute``, the toolkit sync entry points, the
resilience retry loop, elastic snapshots):

- **Off by default.** Every instrumented site guards on one attribute read
  (``RECORDER.enabled``) and takes the original code path when False — no
  host sync, no extra collectives, no allocation. Even ON, the step path
  adds no host synchronization, no device allocation and no collective:
  recording is a host-side ring append. Nothing the recorder does runs
  between a CUDA-graph capture's begin and end (``metrics/_fuse.py``
  captures inside an update; the update's span opens before and closes
  after it).
- **Bounded.** Events land in a thread-safe ring buffer
  (:class:`EventLog`); a forgotten recorder cannot grow without bound —
  old events are dropped (and counted) once ``capacity`` is reached.
- **Composable exporters.** An attached ``export.JsonlWriter`` sees every
  recorded event (async bounded-queue writer — the step path never waits
  for disk unless the queue backs up, which is the backpressure contract
  inherited from the elastic snapshot writer).

Enable via ``config.observability(...)`` (scoped), ``obs.enable()``
(process-wide), or env ``TORCHEVAL_TPU_OBSERVABILITY`` (truthy enables at
import; a value ending in ``.jsonl`` also attaches a JSONL writer at that
path).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, Iterator, List, Optional

from torcheval_tpu_torch import config
from torcheval_tpu_torch.obs import trace as _trace
from torcheval_tpu_torch.obs.events import Event, SpanEvent

__all__ = ["EventLog", "Recorder", "RECORDER", "enable", "disable", "enabled", "recorder", "span"]

DEFAULT_CAPACITY = 4096


class EventLog:
    """Thread-safe bounded ring buffer of :class:`Event`.

    ``capacity`` bounds memory; once full, the oldest events are dropped
    (``dropped`` counts them, ``total`` counts every append ever). Reads
    (:meth:`tail`, iteration) snapshot under the lock, so concurrent
    appends from worker threads (elastic writer, resilience workers)
    never corrupt a reader.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._buf: deque = deque(maxlen=self.capacity)  # tev: guarded-by=_lock
        self._lock = threading.Lock()
        self.total = 0  # tev: guarded-by=_lock
        self.counts: Dict[str, int] = {}  # tev: guarded-by=_lock

    def append(self, event: Event) -> None:
        with self._lock:
            self._buf.append(event)
            self.total += 1
            self.counts[event.kind] = self.counts.get(event.kind, 0) + 1

    @property
    def dropped(self) -> int:
        """Events evicted by the ring bound (``total`` minus retained)."""
        with self._lock:
            return self.total - len(self._buf)

    def tail(self, n: Optional[int] = None) -> List[Event]:
        """The newest ``n`` events, oldest-first (all retained if None)."""
        with self._lock:
            events = list(self._buf)
        return events if n is None else events[-n:]

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self.total = 0
            self.counts = {}

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def __iter__(self) -> Iterator[Event]:
        return iter(self.tail())


class _Span:
    """Context manager timing one named phase.

    Opens a causal-tracing frame (``obs/trace.py`` — nested spans and
    events recorded inside parent to this one); while the recorder is on
    the frame is a profiled :class:`~torcheval_tpu_torch.obs.trace.Scope`,
    so the phase also shows up in ``torch.profiler`` traces (a host-side
    range, not NVTX: the CPU build of torch has none). On exit records a
    :class:`~torcheval_tpu_torch.obs.events.SpanEvent` with the measured wall
    duration.
    """

    def __init__(self, recorder: "Recorder", name: str) -> None:
        self._recorder = recorder
        self.name = name
        self.seconds = 0.0
        self._t0 = 0.0
        self._scope: Optional[_trace.Scope] = None
        self.frame = None

    def __enter__(self) -> "_Span":
        self._scope = _trace.Scope(self.name, profiled=self._recorder.enabled)
        self.frame = self._scope.__enter__()
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc_info) -> None:
        # stamped where the phase ends, before its ranges close: the
        # exported start (end less seconds) then meets the profiler's
        t_mono, t_wall = time.monotonic(), time.time()
        self.seconds = t_mono - self._t0
        try:
            self._scope.__exit__(*exc_info)
        finally:
            frame = self.frame
            self._recorder.record(
                SpanEvent(
                    name=self.name,
                    seconds=self.seconds,
                    t_mono=t_mono,
                    t_wall=t_wall,
                    trace=frame.trace_id if frame else None,
                    span=frame.span_id if frame else None,
                    parent=frame.parent_id if frame else None,
                )
            )


class Recorder:
    """Process-global event sink (module singleton :data:`RECORDER`).

    ``enabled`` is a plain attribute, not a property: the instrumented hot
    paths read it on every call, and when False that read is the ENTIRE
    observability cost. All other state (log, step cursor, JSONL writer)
    only matters while enabled.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY) -> None:
        self.enabled: bool = False
        self.log = EventLog(capacity)
        self.step_cursor: Optional[int] = None
        self._writer = None  # export.JsonlWriter
        self._compile_sink_installed = False

    # ----------------------------------------------------------- lifecycle

    def enable(
        self,
        *,
        jsonl: Optional[str] = None,
        capacity: Optional[int] = None,
    ) -> "Recorder":
        """Turn recording on (idempotent).

        Args:
            jsonl: optional path — attach an async JSONL writer; every
                recorded event is appended as one JSON line (closed and
                drained by :meth:`disable`).
            capacity: optional new ring-buffer capacity (replaces the
                log, discarding retained events).
        """
        if capacity is not None and capacity != self.log.capacity:
            self.log = EventLog(capacity)
        if jsonl is not None:
            from torcheval_tpu_torch.obs.export import JsonlWriter

            if self._writer is not None:
                self._writer.close()
            self._writer = JsonlWriter(jsonl)
        self._install_compile_sink()
        # the collective flight recorder (obs/flight.py) rides the same
        # switch: recording ON means the sync path's collectives leave
        # per-thread flight rings too. Source-keyed, so an armed stall
        # watchdog keeps flight data when the event recorder turns off.
        from torcheval_tpu_torch.obs.flight import FLIGHT

        FLIGHT.enable("recorder")
        self.enabled = True
        return self

    def disable(self) -> None:
        """Turn recording off; drain and close any attached JSONL writer
        (writer errors ferried by the writer surface here). Releases the
        recorder's flight-recorder enable source (an armed watchdog's
        source, if any, keeps flight recording on)."""
        self.enabled = False
        from torcheval_tpu_torch.obs.flight import FLIGHT

        FLIGHT.disable("recorder")
        writer, self._writer = self._writer, None
        if writer is not None:
            writer.close()

    def _install_compile_sink(self) -> None:
        """Bridge ``utils.compile_counter``'s capture sink into
        :class:`~torcheval_tpu_torch.obs.events.CompileEvent`\\ s (one a
        CUDA-graph capture). Installed once; the sink itself checks
        ``enabled`` so a disabled recorder costs one attribute read per
        capture (captures are rare and expensive). ``_fuse`` calls it after
        the capture has ended, never inside it."""
        if self._compile_sink_installed:
            return
        from torcheval_tpu_torch.obs.events import CompileEvent
        from torcheval_tpu_torch.utils import compile_counter

        def sink(what: str, seconds: float, bucket: int = 0) -> None:
            if self.enabled:
                # causal attribution: the innermost open span at capture
                # time NAMES the site that demanded the graph (e.g. the
                # update wrapper's "torcheval.update/<Metric>"); the
                # capture knows its bucket, else the bucketed dispatch
                # annotated it on the frame
                frame = _trace.current()
                if not bucket and frame is not None:
                    bucket = int(frame.annotations.get("bucket", 0))
                self.record(
                    CompileEvent(
                        seconds=seconds,
                        cache_hit=(what == "cache_hit"),
                        site=frame.name if frame is not None else "",
                        bucket=int(bucket),
                    )
                )

        compile_counter.add_event_sink(sink)
        self._compile_sink_installed = True

    # ------------------------------------------------------------ recording

    def record(self, event: Event) -> None:
        """Stamp the timing envelope (if unset) and append to the ring;
        forward to the JSONL writer when one is attached. Host-side only:
        no device interaction, no collectives. A DISABLED recorder drops
        the event — the off-by-default contract holds at this choke point
        for every producer, including user ``span()`` phases (not just
        the instrumented sites, which also guard for speed)."""
        if not self.enabled:
            return
        if event.t_mono == 0.0:
            event.t_mono = time.monotonic()
            event.t_wall = time.time()
        if event.step is None:
            event.step = self.step_cursor
        if event.tid is None:
            event.tid = threading.get_ident()
        if event.trace is None:
            # causal stamp: a point event recorded inside an open span
            # inherits its trace and parents to it (duration events set
            # their own span/parent before recording and skip this)
            frame = _trace.current()
            if frame is not None:
                event.trace = frame.trace_id
                if event.span is None and event.parent is None:
                    event.parent = frame.span_id
        self.log.append(event)
        writer = self._writer
        if writer is not None:
            writer.write(event)

    def set_step(self, step: Optional[int]) -> None:
        """Advance the step cursor stamped into subsequent events.
        ``elastic.ElasticSession.step_done`` calls this automatically;
        plain loops call it themselves."""
        self.step_cursor = None if step is None else int(step)

    def span(self, name: str) -> _Span:
        """Time one named phase: ``with RECORDER.span("eval-epoch"): ...``
        records a ``SpanEvent`` AND, while recording, opens a
        ``torch.profiler.record_function`` range, so the phase is visible
        both in the event log and in a ``torch.profiler`` trace."""
        return _Span(self, name)

    def drain(self) -> None:
        """Block until the attached JSONL writer (if any) has flushed
        every queued event; re-raise any ferried writer error."""
        if self._writer is not None:
            self._writer.drain()

    def reset(self) -> None:
        """Clear the ring buffer and step cursor (the enabled flag and
        any attached writer are untouched)."""
        self.log.clear()
        self.step_cursor = None


RECORDER = Recorder()


def recorder() -> Recorder:
    """The process-global :class:`Recorder` singleton."""
    return RECORDER


def enable(*, jsonl: Optional[str] = None, capacity: Optional[int] = None) -> Recorder:
    """Module-level sugar for ``recorder().enable(...)``."""
    return RECORDER.enable(jsonl=jsonl, capacity=capacity)


def disable() -> None:
    """Module-level sugar for ``recorder().disable()``."""
    RECORDER.disable()


def enabled() -> bool:
    """Whether the global recorder is currently recording."""
    return RECORDER.enabled


def span(name: str) -> _Span:
    """Module-level sugar for ``recorder().span(name)``."""
    return RECORDER.span(name)


# Env knob: TORCHEVAL_TPU_OBSERVABILITY. Truthy values enable the recorder
# at import; a value ending in ".jsonl" additionally attaches a JSONL
# writer at that path. Same spelling family as the other config env knobs.
_ENV = os.environ.get("TORCHEVAL_TPU_OBSERVABILITY", "").strip()
if _ENV:
    if _ENV.endswith(".jsonl"):
        RECORDER.enable(jsonl=_ENV)
    elif _ENV.lower() in config._TRUTHY:
        RECORDER.enable()
