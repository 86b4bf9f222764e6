"""The program's own spans in a profiled stretch of a panel pass: the
spans window.

While its observability recorder is on, ``torcheval_tpu_torch`` opens a
``torch.profiler.record_function`` range for each of its host phases:
``torcheval.update_collection`` around a panel update, inside it
``torcheval.plan/<Metric>`` (validation, conversion, padding) and
``torcheval.accumulate/<Metric>`` (enqueueing the plan's state kernels;
``torcheval.replay`` for a graphed group) for each metric with a plan,
``torcheval.update/<Metric>`` for each metric without one,
``torcheval.k1`` around K1's wrapper and ``torcheval.buffer.grow`` around a
buffer's growth copy. With the recorder off none of them opens.

``SpansWindow`` profiles a stretch of batches, each inside the
benchmark's own ``evalbench.update`` range, with the recorder on (or off,
for the stretch it is compared with), and ``reduce_spans`` reduces its
chrome trace per batch: the host microseconds of each ``torcheval.*``
range nested in the batch's ``evalbench.update``, K1's spans, the device
operations launched inside ``torcheval.update_collection`` (matched by
correlation id, as ``evalbench.trace.reduce_trace`` matches them), and the
device's idle time, each gap put down to the innermost ``torcheval.*``
range (else ``evalbench.*``) open on the host when it began. The readers
``layers/{plan_host_us, accumulate_host_us, k1_host_us, panel_launches,
append_host_us, growth_copies}.py`` read the reduced record under
``"spans"`` (and the growth counter under ``"buffer_growths"``), and find
nothing in a program that opens no such range.

The harness's eval loop does not open a spans window yet. ``main`` runs
one on a card for a Criteo cell, beside a window with the recorder off,
and prints what the readers read::

    python3 evalbench/spans.py --workload criteo_stream_pass --seed 7 --repeats 3
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import os
import statistics
import sys
import tempfile
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import torch

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from evalbench.trace import _DEVICE_CATS, _merge, _open_at  # noqa: E402

WINDOW = "evalbench.spans"
UPDATE = "evalbench.update"
PROGRAM = "torcheval."
COLLECTION = "torcheval.update_collection"
K1 = "torcheval.k1"
TOP = 10
_NULL = contextlib.nullcontext()


class SpansWindow:
    """One profiled stretch; ``recorder`` turns the program's recorder on
    for its length (off and reset after it). ``record`` holds
    ``reduce_spans`` of the stretch once it has stopped."""

    def __init__(self, device, recorder: bool = True) -> None:
        self.cuda = torch.device(device).type == "cuda"
        self.recorder = recorder
        self.record: Optional[dict] = None
        self._prof = None
        self._window = None

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        from torcheval_tpu_torch import obs

        self._sync()
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self._prof = profile(activities=activities)
        self._prof.start()
        if self.recorder:
            obs.enable()
        self._window = torch.profiler.record_function(WINDOW)
        self._window.__enter__()

    def stop(self) -> dict:
        from torcheval_tpu_torch import obs

        self._sync()
        self._window.__exit__(None, None, None)
        if self.recorder:
            obs.disable()
            obs.recorder().reset()
        self._prof.stop()
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        self._prof = self._window = None
        self.record = reduce_spans(events)
        return self.record


def _xs(events: List[dict]) -> List[dict]:
    return [e for e in events if e.get("ph") == "X" and "ts" in e and "dur" in e]


def reduce_spans(events: List[dict]) -> Optional[dict]:
    """The spans window of a chrome trace, in µs a batch and seconds of
    idle time; None when the trace holds no ``evalbench.spans`` window.

    ``batches``: one entry an ``evalbench.update`` range, in order:
    ``update_us`` (its host time), ``spans_us`` (the summed host µs of each
    ``torcheval.*`` range name nested in it), ``k1_us`` (each
    ``torcheval.k1`` span), ``collections`` (the ``torcheval.update_collection``
    ranges in it) and ``launches`` (device operations launched inside
    them). ``idle_by_span``: the device's idle seconds in the window by the
    innermost program range open when each gap began (top ``TOP``)."""
    xs = _xs(events)
    windows = [e for e in xs if e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
    if not windows:
        return None
    w0 = float(windows[0]["ts"])
    w1 = w0 + float(windows[0]["dur"])
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in xs
                  if e.get("cat") == "user_annotation" and e["name"] != WINDOW
                  and e["name"].startswith((PROGRAM, "evalbench.")) and w0 <= float(e["ts"]) < w1)
    starts = [h[0] for h in host]
    updates = [h for h in host if h[2] == UPDATE]
    # the window starts at its first range: before it, the profiler's start
    w0 = starts[0] if starts else w0

    batches = []
    collections = []  # (start, end, batch index)
    for i, (a, b, _) in enumerate(updates):
        spans_us: Dict[str, float] = defaultdict(float)
        k1_us = []
        n_coll = 0
        for c, d, name in host[bisect.bisect_left(starts, a): bisect.bisect_right(starts, b)]:
            if d > b or not name.startswith(PROGRAM):
                continue
            spans_us[name] += d - c
            if name == K1:
                k1_us.append(d - c)
            elif name == COLLECTION:
                collections.append((c, d, i))
                n_coll += 1
        batches.append({"update_us": b - a, "spans_us": dict(spans_us), "k1_us": k1_us,
                        "collections": n_coll, "launches": 0})

    launches = {e["args"]["correlation"]: float(e["ts"]) for e in xs
                if str(e.get("cat", "")).startswith("cuda_") and "correlation" in e.get("args", {})}
    coll_starts = [c[0] for c in collections]
    busy = []
    for e in xs:
        if e.get("cat") not in _DEVICE_CATS:
            continue
        t = launches.get(e.get("args", {}).get("correlation"))
        if t is not None:
            k = bisect.bisect_right(coll_starts, t) - 1
            if k >= 0 and t <= collections[k][1]:
                batches[collections[k][2]]["launches"] += 1
        a, b = max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1)
        if b > a:
            busy.append((a, b))
    busy = _merge(busy)

    program = [h for h in host if h[2].startswith(PROGRAM)]
    program_starts = [h[0] for h in program]
    idle: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for k in range(0, len(edges), 2):
        at, length = edges[k], edges[k + 1] - edges[k]
        if length <= 0:
            continue
        inner = _open_at(program, program_starts, at) or _open_at(host, starts, at)
        idle[inner[-1] if inner else "outside ranges"] += length / 1e6
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "batches": batches,
        "idle_by_span": [[k, v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]],
    }


def batch_median_us(record: dict, wanted: Callable[[str], bool]) -> Optional[float]:
    """Median over the spans window's batches of the summed host µs of the
    ranges ``wanted`` names; None without a spans window or where no
    batch holds such a range."""
    spans = (record or {}).get("spans")
    if not spans or not spans["batches"]:
        return None
    sums = [sum(us for name, us in b["spans_us"].items() if wanted(name)) for b in spans["batches"]]
    if not any(any(wanted(name) for name in b["spans_us"]) for b in spans["batches"]):
        return None
    return statistics.median(sums)


# ------------------------------------------------------------- on a card


def _growths() -> Optional[int]:
    """The program's buffer growth count, or None where it has none."""
    from torcheval_tpu_torch.metrics import _buffer

    counts = getattr(_buffer, "growth_counts", None)
    return None if counts is None else counts()["growths"]


def measure(cell, seed: int, repeats: int, device) -> dict:
    """For ``repeats`` pairs of passes of a Criteo cell (``spec.Cell``): a profiled stretch
    with the recorder off in the first pass and one with it on (the spans
    window) at the same batch of the next, each of the traffic's
    ``trace["batches"]`` batches from ``trace["start_batch"]``; what the
    readers read from each spans window, and both stretches' median
    ``evalbench.update`` host µs."""
    from evalbench import spec
    from evalbench import traffic as gen
    from evalbench.trace import Tracer
    from torcheval_tpu_torch import obs
    from torcheval_tpu_torch.metrics._buffer import BufferedExamplesMetric

    loop = spec.loop(cell)
    tr = cell.traffic
    at, count = tr["trace"]["start_batch"], tr["trace"]["batches"]
    readers = {name: spec._load(spec.reader_path(spec.ROOT, name), f"evalbench_spans_{name}")
               for name in ("plan_host_us", "accumulate_host_us", "k1_host_us", "panel_launches",
                            "append_host_us", "growth_copies")}
    tracer = Tracer(True)
    with torch.no_grad():
        scores, labels = gen.click_eval_set(cell.config, seed, device)
        views = [(scores[a:b], labels[a:b]) for a, b in gen.batches(scores.numel(), tr["batch"])]
        metrics, groups = loop._panel(tr["panel"], device)
        buffered = sorted({type(m).__name__ for m in metrics.values()
                           if isinstance(m, BufferedExamplesMetric)})
        tracer.warm(device)
        for _ in range(tr["warmup_passes"]):
            for s, y in views:
                loop._update(groups, s, y)
            loop._end_pass(metrics)
        n = len(views)
        out = []
        for _ in range(repeats):
            g0, passes = _growths(), 0
            # stretch k starts at batch `at` of the k-th pass of the repeat
            # (it may run on past the pass end, as the harness's does):
            # profiled with the recorder off, then on (the spans window),
            # then unprofiled with it off and on (host clock alone)
            windows = [SpansWindow(device, recorder=False), SpansWindow(device, recorder=True),
                       None, None]
            host_us: List[List[float]] = [[] for _ in windows]
            j, last = 0, len(windows) * n + at + count - 1
            while j <= last or j % n:
                i, k = j % n, j // n
                if k < len(windows) and i == at:
                    if windows[k] is not None:
                        windows[k].start()
                    elif k == 3:
                        obs.enable()
                inside = [w for w in range(len(windows)) if w * n + at <= j < w * n + at + count]
                profiled = any(windows[w] is not None for w in inside)
                h0 = time.perf_counter()
                with torch.profiler.record_function(UPDATE) if profiled else _NULL:
                    loop._update(groups, *views[i])
                us = (time.perf_counter() - h0) * 1e6
                for w in inside:
                    host_us[w].append(us)
                    if j == w * n + at + count - 1:
                        if windows[w] is not None:
                            windows[w].stop()
                        elif w == 3:
                            obs.disable()
                            obs.recorder().reset()
                if i == n - 1:
                    with torch.profiler.record_function("evalbench.compute") if profiled else _NULL:
                        loop._end_pass(metrics)
                    passes += 1
                j += 1
            g1 = _growths()
            off, spans = windows[0].record, windows[1].record
            if off is None or spans is None:
                raise RuntimeError("a profiled stretch held no evalbench.spans window")
            record = {"spans": spans, "buffered_classes": buffered,
                      "buffer_growths": None if g0 is None else {"growths": g1 - g0, "passes": passes}}
            update_us = statistics.median(b["update_us"] for b in spans["batches"])
            collection_us = statistics.median(b["spans_us"].get(COLLECTION, 0.0)
                                              for b in spans["batches"])
            read = {name: r.read(record) for name, r in readers.items()}
            parts = (read["plan_host_us"], read["accumulate_host_us"])
            out.append({
                "readings": read,
                "update_us": dict(zip(("profiled_off", "profiled_on", "bare", "armed"),
                                      map(statistics.median, host_us))),
                "range_update_us_recorder_off": statistics.median(
                    b["update_us"] for b in off["batches"]),
                "range_update_us_recorder_on": update_us,
                "collection_us": collection_us,
                "collection_over_update": collection_us / update_us,
                "plan_accumulate_over_update": None if None in parts
                else sum(parts) / update_us,
                "plan_accumulate_over_collection": None if None in parts
                else sum(parts) / collection_us,
                "idle_by_span": spans["idle_by_span"],
                "busy_s": spans["busy_s"], "window_s": spans["window_s"],
                "busy_s_recorder_off": off["busy_s"], "window_s_recorder_off": off["window_s"],
                "idle_by_span_recorder_off": off["idle_by_span"],
            })
        if obs.enabled():
            raise RuntimeError("the recorder was left on after a spans window")
    return {"workload": cell.name, "seed": seed, "device": str(device),
            "kind": torch.cuda.get_device_name(device) if torch.device(device).type == "cuda" else "cpu",
            "repeats": out}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="spans window of a Criteo cell on a card")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("evalbench.spans: no CUDA device", file=sys.stderr)
        return 2
    from evalbench import spec

    cell = spec.cell(args.workload)
    print(json.dumps(measure(cell, args.seed, args.repeats, torch.device(args.device))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
