"""Fixed-bucket log₂ latency histograms: O(1) insert, mergeable.

Counterpart of ``torcheval_tpu/obs/hist.py``, the same buckets and merge
order. The event stream carries every individual latency, but a ring
buffer is the wrong structure for "what is the p99 update latency over
the last hour" — old events are evicted, and answering a quantile from
events means a sort at read time. :class:`LatencyHistogram` is the
digest the question wants:

- **Fixed log₂ buckets**: bucket *i* counts samples in
  ``[2^(i-1), 2^i)`` microseconds (bucket 0 is the sub-µs bucket, the
  last bucket is unbounded). 40 buckets span sub-µs to ~7.6 days —
  latencies live on a log scale, so ~2× resolution everywhere is the
  right trade for a fixed-size, allocation-free structure.
- **O(1) insert** (:meth:`observe`): one ``int.bit_length`` and two adds
  under a plain lock — cheap enough to sit behind the recorder-gated
  update/compute/sync timers.
- **Mergeable, bit-identically** (:meth:`merge`): counts are integers
  and the running ``sum`` is accumulated in a fixed order, so every rank
  merging the same per-rank snapshots in the same (ascending-rank) order
  produces the same bits — the merge-oracle property the cross-rank
  scrape relies on.
- **Approximate quantiles** (:meth:`quantile`): the upper bound of the
  bucket holding the target sample — conservative (never under-reports),
  within one bucket (≤2×) of the true value by construction.

The process-global registry (:func:`observe` / :func:`snapshot`) is what
the instrumented sites feed; ``export.render_prometheus`` emits each key
as a proper ``# TYPE ... histogram`` with cumulative ``_bucket`` series,
``_sum`` and ``_count``; ``export.format_report`` prints p50/p99.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

__all__ = [
    "LatencyHistogram",
    "NUM_BUCKETS",
    "bucket_index",
    "bucket_upper_bounds_us",
    "observe",
    "reset",
    "snapshot",
]

NUM_BUCKETS = 40


def bucket_index(seconds: float) -> int:
    """The log₂ bucket for a latency: ``int(µs).bit_length()`` clamped.

    0 µs → bucket 0; 1 µs → 1; 2-3 µs → 2; ...; everything at or above
    ``2^(NUM_BUCKETS-2)`` µs lands in the last, unbounded bucket.
    """
    us = int(seconds * 1e6)
    if us <= 0:
        return 0
    return min(us.bit_length(), NUM_BUCKETS - 1)


def bucket_upper_bounds_us() -> List[float]:
    """Exclusive upper bound of each bucket in µs (last is +Inf)."""
    return [2.0 ** i for i in range(NUM_BUCKETS - 1)] + [float("inf")]


class LatencyHistogram:
    """One fixed-shape latency digest (see module docstring)."""

    __slots__ = ("counts", "sum", "count", "_lock")

    def __init__(self) -> None:
        self.counts = [0] * NUM_BUCKETS  # tev: guarded-by=_lock
        self.sum = 0.0  # tev: guarded-by=_lock
        self.count = 0  # tev: guarded-by=_lock
        self._lock = threading.Lock()

    def observe(self, seconds: float) -> None:
        """O(1): one bucket increment + running sum/count."""
        idx = bucket_index(seconds)
        with self._lock:
            self.counts[idx] += 1
            self.sum += seconds
            self.count += 1

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """Fold ``other`` into self (elementwise counts, ``sum += other``;
        merging snapshots in a fixed order is bit-identical everywhere)."""
        with self._lock:
            for i, c in enumerate(other.counts):
                self.counts[i] += c
            self.sum += other.sum
            self.count += other.count
        return self

    def quantile(self, q: float) -> Optional[float]:
        """Approximate q-quantile in SECONDS: the upper bound of the
        bucket containing the ⌈q·count⌉-th sample (None when empty; the
        unbounded last bucket reports its lower bound)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            total = self.count
            counts = list(self.counts)
        if total == 0:
            return None
        target = max(1, int(q * total + 0.999999))
        seen = 0
        for i, c in enumerate(counts):
            seen += c
            if seen >= target:
                exp = i if i < NUM_BUCKETS - 1 else NUM_BUCKETS - 2
                return (2.0 ** exp) / 1e6
        return (2.0 ** (NUM_BUCKETS - 2)) / 1e6  # unreachable

    # ------------------------------------------------------- serialization

    def as_dict(self) -> Dict[str, object]:
        """JSON-safe snapshot (the cross-rank gather payload)."""
        with self._lock:
            return {
                "counts": list(self.counts),
                "sum": self.sum,
                "count": self.count,
            }

    @classmethod
    def from_dict(cls, data: Dict[str, object]) -> "LatencyHistogram":
        h = cls()
        counts = list(data.get("counts", ()))  # type: ignore[arg-type]
        if len(counts) != NUM_BUCKETS:
            raise ValueError(
                f"histogram snapshot has {len(counts)} buckets, "
                f"expected {NUM_BUCKETS}"
            )
        h.counts = [int(c) for c in counts]
        h.sum = float(data.get("sum", 0.0))  # type: ignore[arg-type]
        h.count = int(data.get("count", 0))  # type: ignore[arg-type]
        return h

    def __eq__(self, other: object) -> bool:
        # snapshot each side under its own lock: a racing insert must
        # not tear the comparison
        if not isinstance(other, LatencyHistogram):
            return NotImplemented
        return self.as_dict() == other.as_dict()


# --------------------------------------------------------- global registry

_REGISTRY: Dict[str, LatencyHistogram] = {}  # tev: guarded-by=_REGISTRY_LOCK
_REGISTRY_LOCK = threading.Lock()


def observe(key: str, seconds: float) -> None:
    """Record one latency under ``key`` in the process-global registry
    (keys like ``update/MulticlassAccuracy``, ``compute/Mean``,
    ``sync`` — what the instrumented sites feed while the recorder is
    on). Creates the histogram on first use. The insert is inlined
    (rather than delegating to :meth:`LatencyHistogram.observe`) — this
    sits on the recorder-ON update path, where call depth is budget."""
    h = _REGISTRY.get(key)  # tev: disable=guarded-field -- lock-free dict probe on the recorder-ON update path; two racers both fall through to the locked setdefault, which picks one winner
    if h is None:
        with _REGISTRY_LOCK:
            h = _REGISTRY.setdefault(key, LatencyHistogram())
    us = int(seconds * 1e6)
    idx = min(us.bit_length(), NUM_BUCKETS - 1) if us > 0 else 0
    with h._lock:
        h.counts[idx] += 1
        h.sum += seconds
        h.count += 1


def snapshot() -> Dict[str, LatencyHistogram]:
    """A point-in-time copy of the registry: ``{key: histogram-copy}``
    (safe to merge/serialize without racing live inserts)."""
    with _REGISTRY_LOCK:
        keys = list(_REGISTRY.items())
    return {k: LatencyHistogram.from_dict(h.as_dict()) for k, h in keys}


def reset() -> None:
    """Drop every registered histogram (tests and benchmarks)."""
    with _REGISTRY_LOCK:
        _REGISTRY.clear()
