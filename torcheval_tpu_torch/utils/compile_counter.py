"""CUDA-graph capture counting: the port's ``CompileCounter``.

Counterpart of ``torcheval_tpu/utils/compile_counter.py``, with the same
``programs`` / ``compiles`` / ``cache_hits`` / ``compile_secs`` surface,
counting a different thing. The JAX package counts XLA program demands
through ``jax.monitoring``: a ragged stream that retraces shows up as
programs. The port runs eagerly; its nearest counterpart of a compiled
program is a CUDA graph captured for a bucketed update
(``metrics/_fuse.py``), one per bucket signature, or for a panel's
unbucketed plans whose input signature repeats. So here:

- ``programs`` counts captures; every capture is a compile
  (``compiles == programs``) and none is a cache hit (``cache_hits``
  stays 0: a capture is never loaded from a cache);
- ``compile_secs`` is the host time of the captures (warm-up, capture,
  pool bookkeeping).

The two packages' counts are not comparable with each other: an eager
update costs the port no capture and the JAX package a program. What
carries over is the bound: under ``config.shape_bucketing()`` a ragged
stream makes at most ``bucket_bound(max_batch)`` captures per metric
panel, and none once every bucket is warm.

``_fuse`` calls :func:`note_capture` at each capture; counters active in
a ``with`` block and registered event sinks (the observability
recorder's, which turns captures into ``CompileEvent``\\ s) see it.
Captures happen only on the card; on the CPU the counts stay 0.

The JAX package's ``enable_persistent_compilation_cache`` has no
counterpart here: a CUDA graph cannot outlive its process.
"""

from __future__ import annotations

import threading
from typing import Callable, List

__all__ = ["CompileCounter", "add_event_sink", "note_capture", "remove_event_sink"]

# Counters inside their `with` block, and event sinks
# ``sink(what, seconds, bucket)`` (``what`` is always "compile" here).
# Sinks must be cheap and must not raise.
_ACTIVE: List["CompileCounter"] = []  # tev: guarded-by=_LOCK
_EVENT_SINKS: List[Callable[[str, float, int], None]] = []  # tev: guarded-by=_LOCK
_LOCK = threading.Lock()


def add_event_sink(sink: Callable[[str, float, int], None]) -> None:
    """Register a capture sink (see ``_EVENT_SINKS``)."""
    with _LOCK:
        if sink not in _EVENT_SINKS:
            _EVENT_SINKS.append(sink)


def remove_event_sink(sink: Callable[[str, float, int], None]) -> None:
    with _LOCK:
        if sink in _EVENT_SINKS:
            _EVENT_SINKS.remove(sink)


def note_capture(seconds: float, bucket: int = 0) -> None:
    """One CUDA-graph capture that took ``seconds`` of host time, of an
    update whose largest bucket length is ``bucket`` (0 for an unbucketed
    group; called by ``metrics/_fuse.py``)."""
    with _LOCK:
        counters = list(_ACTIVE)
        sinks = list(_EVENT_SINKS)
    for counter in counters:
        counter._note(seconds)
    for sink in sinks:
        sink("compile", seconds, bucket)


class CompileCounter:
    """Counts CUDA-graph captures within a ``with`` block.

    >>> from torcheval_tpu_torch.utils import CompileCounter
    >>> with CompileCounter() as cc:
    ...     pass  # a bucketed eval loop on the card
    >>> (cc.programs, cc.compiles, cc.cache_hits)
    (0, 0, 0)

    Counts are process-wide (a capture on any thread inside the block is
    counted); nested counters each see every capture.
    """

    def __init__(self) -> None:
        self._programs = 0  # tev: guarded-by=_lock
        self._compile_secs = 0.0  # tev: guarded-by=_lock
        self._lock = threading.Lock()

    def _note(self, seconds: float) -> None:
        with self._lock:
            self._programs += 1
            self._compile_secs += float(seconds)

    @property
    def programs(self) -> int:
        """CUDA graphs captured: the quantity the bucket bound limits."""
        with self._lock:
            return self._programs

    @property
    def compiles(self) -> int:
        """Captures that paid for a capture: all of them."""
        return self.programs

    @property
    def cache_hits(self) -> int:
        """Always 0: a capture is never served from a cache."""
        return 0

    @property
    def compile_secs(self) -> float:
        with self._lock:
            return self._compile_secs

    def reset(self) -> None:
        with self._lock:
            self._programs = 0
            self._compile_secs = 0.0

    def __enter__(self) -> "CompileCounter":
        with _LOCK:
            _ACTIVE.append(self)
        return self

    def __exit__(self, *exc_info) -> None:
        with _LOCK:
            _ACTIVE.remove(self)
