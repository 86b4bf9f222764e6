"""Causal tracing: trace/span context underneath the event recorder.

Counterpart of ``torcheval_tpu/obs/trace.py``, the same machinery. The
event stream answers *what happened*; this module answers *what caused
what*. Every span gets a *span id* and a *parent span id*, and every root
span opens a *trace id* — so one eval step (update panel → bucketed
dispatch → CUDA-graph capture → sync → retries → snapshot) is a connected
tree instead of a flat timeline. The machinery is a plain
thread-local stack of :class:`SpanFrame`\\ s:

- **Instrumented sites push a frame** for the duration of the phase
  (``Metric.update``/``compute`` wrappers, the toolkit sync, elastic
  snapshot/restore, user ``obs.span()`` phases) via :class:`Scope`. A
  site traced only while the recorder is on (:func:`scope_or_null`) also
  opens a ``torch.profiler.record_function`` range of the frame's name
  while a profiler collects, so the phase lands in a ``torch.profiler``
  trace on the device trace's clock. In the metric core such frames mark each
  metric's plan (``torcheval.plan/<Metric>``), its accumulate
  (``torcheval.accumulate/<Metric>``, or ``torcheval.replay`` for a
  graphed group), K1's wrapper (``torcheval.k1``) and a buffer's growth
  (``torcheval.buffer.grow``); they record no event.
- **Point events inherit the current frame**: ``Recorder.record`` stamps
  ``trace``/``parent`` from :func:`current` onto any event that does not
  carry its own span — a ``RetryEvent`` emitted during a sync parents to
  the sync span, a ``CompileEvent`` (a graph capture) fired inside an
  update parents to that update (and names it, see ``site`` attribution
  in the recorder's compile sink).
- **Flow ids link the same collective across ranks**
  (:func:`next_flow_id`): collectives run in lockstep, so "this rank's
  N-th eager sync" IS the same sync on every rank — a per-thread ordinal
  needs ZERO communication to agree across ranks (the same reasoning
  that makes the lockstep checker's per-rank plans comparable). The
  Chrome exporter turns shared flow ids into Perfetto flow arrows.

Cost contract: everything here is host-side list/int work guarded by the
recorder's single ``enabled`` attribute read at the instrumented sites —
tracing-ON adds no host sync, no device allocation and no collective to
any step path.
"""

from __future__ import annotations

import contextlib as _contextlib
import itertools
import os
import threading
from typing import Any, Dict, List, Optional

import torch

__all__ = [
    "Scope",
    "SpanFrame",
    "active_stack",
    "annotate",
    "capture_error",
    "clear_error_stack",
    "current",
    "last_error_stack",
    "next_flow_id",
    "pop",
    "push",
    "scope_or_null",
    "thread_paths",
    "trace_path",
]

_TLS = threading.local()

# Cross-thread view of the per-thread span stacks, for the stall watchdog
# (obs/watchdog.py): a watchdog thread diagnosing a hang must name the
# span path of the STALLED thread, which thread-local state alone cannot
# answer. Each thread registers its (mutable) stack list on first use;
# entries are tiny and thread counts bounded, so stale tids are harmless.
_ALL_STACKS: Dict[int, List["SpanFrame"]] = {}

# Span ids are process-unique (itertools.count.__next__ is atomic under
# the GIL); trace ids additionally carry a random 32-bit process prefix
# so traces merged from several ranks/processes never collide.
_SPAN_IDS = itertools.count(1)
_TRACE_IDS = itertools.count(1)
_TRACE_PREFIX = int.from_bytes(os.urandom(4), "big")


class SpanFrame:
    """One live span on a thread's context stack.

    ``annotations`` is a scratch dict instrumented code deeper in the
    call can stamp context onto (e.g. the bucketed dispatch notes its
    bucket length so a compile fired under it is attributed to the
    shape bucket that demanded it). The frame dies when the phase exits,
    so annotations can never go stale across calls.
    """

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "annotations")

    def __init__(
        self,
        trace_id: int,
        span_id: int,
        parent_id: Optional[int],
        name: str,
    ) -> None:
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.annotations: Dict[str, Any] = {}


def _stack() -> List[SpanFrame]:
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
        _ALL_STACKS[threading.get_ident()] = stack
    return stack


def push(name: str) -> SpanFrame:
    """Open a span: child of the current frame, or a new trace root.
    (Hot when the recorder is on — one try/except TLS read, one
    :class:`SpanFrame` allocation, two counter bumps.)"""
    try:
        stack = _TLS.stack
    except AttributeError:
        stack = _TLS.stack = []
        _ALL_STACKS[threading.get_ident()] = stack
    if stack:
        top = stack[-1]
        frame = SpanFrame(top.trace_id, next(_SPAN_IDS), top.span_id, name)
    else:
        trace_id = (_TRACE_PREFIX << 32) | next(_TRACE_IDS)
        frame = SpanFrame(trace_id, next(_SPAN_IDS), None, name)
    stack.append(frame)
    return frame


def pop(frame: SpanFrame) -> None:
    """Close a span. Tolerates a corrupted stack (pops through to the
    given frame) so one mismatched site cannot poison a whole thread."""
    try:
        stack = _TLS.stack
    except AttributeError:
        return
    if stack and stack[-1] is frame:  # the overwhelmingly common case
        stack.pop()
        return
    while stack:
        if stack.pop() is frame:
            return


def capture_error(exc: BaseException) -> None:
    """Capture the CURRENT span path as this thread's error stack —
    called by instrumented sites from an ``except`` block, BEFORE their
    ``finally`` pops the failing frame. Identity-keyed on the exception
    so only the innermost site's capture survives the unwind (outer
    sites see the same exception and leave the deeper path in place)."""
    if getattr(_TLS, "error_for", None) is not exc:
        _TLS.error_for = exc
        _TLS.error_stack = [f.name for f in getattr(_TLS, "stack", ())]


def current() -> Optional[SpanFrame]:
    """The innermost open span on this thread, or None."""
    stack = getattr(_TLS, "stack", None)
    return stack[-1] if stack else None


def active_stack() -> List[SpanFrame]:
    """Snapshot of this thread's open spans, outermost first."""
    return list(getattr(_TLS, "stack", ()))


def trace_path(frames: Optional[List[SpanFrame]] = None) -> str:
    """Human-readable span path, outermost first: ``"a > b > c"``."""
    if frames is None:
        frames = active_stack()
    return " > ".join(f.name for f in frames)


def thread_paths() -> Dict[int, str]:
    """Every thread's current span path (``{tid: "a > b"}``), threads
    with no open span omitted — the watchdog's "where was each thread"
    answer. List append/pop is atomic under the GIL and the snapshot
    copies before formatting, so no locking is needed."""
    out: Dict[int, str] = {}
    for tid, stack in list(_ALL_STACKS.items()):
        frames = list(stack)
        if frames:
            out[tid] = " > ".join(f.name for f in frames)
    return out


def annotate(**kwargs: Any) -> None:
    """Stamp context onto the current frame (no-op outside any span)."""
    frame = current()
    if frame is not None:
        frame.annotations.update(kwargs)


class Scope:
    """Context manager opening one span frame for a code region.

    On an exception the full span path (this frame included) is captured
    as the thread's *error stack* before unwinding pops it — the
    conftest failure hook appends it to test reports ("the trace path to
    the failing site"). Identity-keyed on the exception, so only the
    INNERMOST frame's capture survives the unwind.

    ``profiled=True`` also opens a ``torch.profiler.record_function``
    range of the same name around the frame while a profiler is
    collecting: the one place a program span reaches the profiler. With
    none collecting the range would record nothing, and it costs several
    times what the frame does, so it is not opened.
    """

    __slots__ = ("name", "frame", "_range")

    def __init__(self, name: str, profiled: bool = False) -> None:
        self.name = name
        self.frame: Optional[SpanFrame] = None
        self._range = (
            torch.profiler.record_function(name)
            if profiled and torch.autograd._profiler_enabled()
            else None
        )

    def __enter__(self) -> SpanFrame:
        if self._range is not None:
            self._range.__enter__()
        self.frame = push(self.name)
        return self.frame

    def __exit__(self, exc_type, exc, tb) -> bool:
        try:
            if exc is not None:
                capture_error(exc)
            if self.frame is not None:
                pop(self.frame)
        finally:
            if self._range is not None:
                self._range.__exit__(exc_type, exc, tb)
        return False


_NULL_SCOPE = _contextlib.nullcontext()


def scope_or_null(name: str, enabled: bool, detail: Optional[str] = None):
    """A profiled :class:`Scope` when ``enabled`` (a span frame and a
    ``torch.profiler.record_function`` range, both named ``name``, or
    ``name/detail`` when ``detail`` is given), else a shared
    ``nullcontext`` (which yields ``None``) — the one-liner every
    conditionally-traced site uses::

        with trace.scope_or_null("torcheval.sync", _OBS.enabled) as frame:
            ...  # frame is the SpanFrame, or None when disabled

    Using the ``with`` protocol (rather than try/finally +
    ``sys.exc_info()``) matters: inside an outer ``except`` handler,
    ``sys.exc_info()`` reports the already-HANDLED exception, and a
    scope exited with it would capture a bogus error stack for a
    perfectly clean call. Disabled cost: one call + a shared, stateless
    context manager — no allocation, and no name is built: a per-metric
    site passes its metric's class as ``detail`` instead of formatting
    the name itself.
    """
    if not enabled:
        return _NULL_SCOPE
    return Scope(name if detail is None else f"{name}/{detail}", profiled=True)


def last_error_stack() -> Optional[List[str]]:
    """The span path captured at the most recent exception that escaped
    a :class:`Scope` on this thread (outermost first), or None."""
    stack = getattr(_TLS, "error_stack", None)
    return list(stack) if stack else None


def clear_error_stack() -> None:
    _TLS.error_for = None
    _TLS.error_stack = None


# ------------------------------------------------------------------- flows

def next_flow_id() -> int:
    """The next cross-rank flow ordinal for THIS thread (1-based).

    Collectives are issued in lockstep, so every rank's N-th call from
    its sync path refers to the SAME logical collective — a per-thread
    counter agrees across ranks (including ThreadWorld, where each rank
    is a thread of one process) without any communication. Stamped into
    ``SyncEvent.flow``; the Chrome exporter draws the arrows.
    """
    n = getattr(_TLS, "flow", 0) + 1
    _TLS.flow = n
    return n
