"""The traced run's record: the benchmark's own ranges around each layer
call, and one profiled sub-window of the card.

Ranges are ``torch.profiler.record_function`` spans named
``evalbench.<layer call>``, opened by the eval loops only in a traced run.
The profiled sub-window is a steady stretch of the measured window, bounded
by synchronizes. Its chrome trace is read back and reduced to device
operations, each attributed to the ranges that were open on the host when
it was launched (by the launch's correlation id), the union of their
intervals (busy time), each range's device extent, and the idle gaps
between them. The trace file lives
in a temporary directory for as long as it is read. CUPTI now and then
drops every kernel of a trace; such a trace is discarded and the loop
traces a later stretch, up to ``ATTEMPTS`` times.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

ATTEMPTS = 4
WINDOW = "evalbench.traced"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


class Tracer:
    """Ranges and the profiled sub-window of one run; inert when
    ``enabled`` is false (an untraced run opens no range)."""

    def __init__(self, enabled: bool) -> None:
        self.enabled = enabled
        self.record: Optional[dict] = None
        self.attempts = 0
        self._prof = None
        self._window = None

    def range(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    @property
    def wanted(self) -> bool:
        """A sub-window should be traced (none kept yet, attempts left)."""
        return self.enabled and self.record is None and self._prof is None and self.attempts < ATTEMPTS

    @property
    def active(self) -> bool:
        return self._prof is not None

    def warm(self, device) -> None:
        """Start CUPTI once in set-up: its first start takes seconds, which
        would otherwise fall inside the measured window."""
        if not self.enabled or torch.device(device).type != "cuda":
            return
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.ones(1, device=device).add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.start()
        self._window = torch.profiler.record_function(WINDOW)
        self._window.__enter__()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self._window.__exit__(None, None, None)
        self._prof.stop()
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        self._prof, self._window = None, None
        self.attempts += 1
        parsed = reduce_trace(events)
        if parsed is not None and parsed["ops"]:
            self.record = parsed


def extents(trace: Optional[dict], name: str) -> List[float]:
    """Seconds from the first device operation to the end of the last of
    each entry of the range ``name`` in a reduced trace."""
    return [s for n, s in (trace or {}).get("range_extents_s", ()) if n == name]


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _open_idx(spans: List[Tuple[float, float, str]], starts: List[float], t: float) -> Tuple[int, ...]:
    """Indices of the spans (sorted by start) that contain ``t``, outermost
    first."""
    return tuple(i for i, (a, b, _) in enumerate(spans[: bisect.bisect_right(starts, t)]) if b >= t)


def _open_at(spans: List[Tuple[float, float, str]], starts: List[float], t: float) -> Tuple[str, ...]:
    """Names of the spans (sorted by start) that contain ``t``, outermost
    first."""
    return tuple(spans[i][2] for i in _open_idx(spans, starts, t))


def reduce_trace(events: List[dict]) -> Optional[dict]:
    """The sub-window's device operations, busy time, per-range device
    time, the device extent of each range entered (first operation it
    launched to the end of its last), top operations and longest idle gaps,
    in seconds. None when the trace holds no ``evalbench.traced``
    window."""
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e and "dur" in e]
    windows = [e for e in xs if e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
    if not windows:
        return None
    w0 = float(windows[0]["ts"])
    w1 = w0 + float(windows[0]["dur"])
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in xs
                   if e.get("cat") == "user_annotation" and e["name"].startswith("evalbench.")
                   and e["name"] != WINDOW)
    span_starts = [s[0] for s in spans]
    # the window starts at the first layer call in it: the stretch before
    # is the profiler's own start-up, not the workload
    w0 = next((a for a in span_starts if w0 <= a < w1), w0)
    launches = {e["args"]["correlation"]: float(e["ts"]) for e in xs
                if str(e.get("cat", "")).startswith("cuda_") and "correlation" in e.get("args", {})}
    ops = []
    extents: Dict[int, List[float]] = {}
    for e in xs:
        if e.get("cat") not in _DEVICE_CATS:
            continue
        a, b = max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1)
        if b <= a:
            continue
        host = launches.get(e.get("args", {}).get("correlation"))
        held = () if host is None else _open_idx(spans, span_starts, host)
        for i in held:
            lo_hi = extents.setdefault(i, [a, b])
            lo_hi[0], lo_hi[1] = min(lo_hi[0], a), max(lo_hi[1], b)
        ops.append((e["name"], a, b, tuple(spans[i][2] for i in held)))
    busy = _merge([(a, b) for _, a, b, _ in ops])
    per_range: Dict[str, float] = defaultdict(float)
    by_name: Dict[str, float] = defaultdict(float)
    for name, a, b, ranges in ops:
        by_name[name] += (b - a) / 1e6
        for r in set(ranges):
            per_range[r] += (b - a) / 1e6
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:TOP]
    cpu = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in xs
                 if e.get("cat") == "cpu_op")
    cpu_starts = [c[0] for c in cpu]
    idle = []
    for length, at in gaps:
        ranges = _open_at(spans, span_starts, at)
        host_ops = _open_at(cpu, cpu_starts, at)
        label = (ranges[-1] if ranges else "outside ranges") + (f" / {host_ops[0]}" if host_ops else "")
        idle.append([label, length / 1e6])
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "ops": [(name, (b - a) / 1e6, ranges) for name, a, b, ranges in ops],
        "range_device_s": dict(per_range),
        "range_extents_s": [[spans[i][2], (b - a) / 1e6] for i, (a, b) in sorted(extents.items())],
        "top_ops": [[k[:120], v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": idle,
    }
