"""Eval passes of a metric panel over a whole CTR eval set.

Set-up draws the eval set on the device from the seed, builds the panel
the traffic file lists (each entry a metric class of
``torcheval_tpu_torch.metrics``, its arguments, the inputs it takes and
the reference that judges it) and runs ``warmup_passes`` whole passes. The
window then streams batch after batch through
``torcheval_tpu_torch.metrics.toolkit.update_collection`` (one call for
each set of metrics that take the same inputs), on one thread, with no
synchronize between batches. At each pass end every metric's ``compute()``
runs, the values are read on the host, and the panel is ``reset()``. The
window closes at the first batch that ends past ``seconds``, with a
synchronize. A traced run profiles ``trace["batches"]`` batches from the
window's batch ``trace["start_batch"]`` on, a stretch that holds a pass
end; a trace that CUPTI emptied is tried again a pass later.

End to end: ``samples_per_s`` (samples absorbed over the window, pass ends
included) and ``update_us_p95`` (host microseconds of a batch's panel
update, 95th percentile over every batch). After the window each pass's
values are compared with the reference's over the same eval set, and the
samples each counting metric holds at the pass end with the eval set's
size.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from evalbench import traffic as gen
from evalbench.harness import Outcome, checks_from
from evalbench.reference import compare
from evalbench.reference import ctr as ref
from torcheval_tpu_torch import metrics as tm
from torcheval_tpu_torch.metrics import toolkit
from torcheval_tpu_torch.metrics._buffer import BufferedExamplesMetric
from torcheval_tpu_torch.ops import _kernels
from torcheval_tpu_torch.utils.compile_counter import CompileCounter

K1 = "fused_auc_hist"


def _panel(entries, device):
    metrics = {m["name"]: getattr(tm, m["metric"])(**m.get("args", {}), device=device)
               for m in entries}
    groups = {}
    for m in entries:
        groups.setdefault(tuple(m["inputs"]), {})[m["name"]] = metrics[m["name"]]
    return metrics, list(groups.items())


def _update(groups, s, y) -> None:
    data = {"scores": s, "labels": y}
    for inputs, members in groups:
        toolkit.update_collection(members, *(data[k] for k in inputs))


def _held(m) -> torch.Tensor:
    """The samples a metric holds, where its state counts them exactly: a
    buffered metric's count, a histogram's total (float32 bins each below
    2^24, summed in float64). None for the rest."""
    if isinstance(m, BufferedExamplesMetric):
        return torch.tensor(float(m.num_samples), dtype=torch.float64)
    if isinstance(m, tm.StreamingBinaryAUROC):
        return m.hist.sum(dtype=torch.float64).cpu()
    return None


def _end_pass(metrics):
    """Every compute(), the values and the held counts read on the host,
    then reset(): (values, held)."""
    values = [m.compute() for m in metrics.values()]
    # a value that is not one number (calibration with no positive returns
    # an empty tensor) reads NaN, which no check passes
    host = torch.stack([v.reshape(-1)[0].float() if v.numel() else v.new_full((), float("nan"))
                        for v in values]).cpu().tolist()
    held = {k: _held(m) for k, m in metrics.items()}
    held = {k: float(v) for k, v in held.items() if v is not None}
    for m in metrics.values():
        m.reset()
    return dict(zip(metrics, host)), held


def run(cell, *, seed, seconds, tracer, device, t0) -> Outcome:
    cfg, tr = cell.config, cell.traffic
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    with torch.no_grad():
        scores, labels = gen.click_eval_set(cfg, seed, device)
        n = scores.numel()
        views = [(scores[a:b], labels[a:b]) for a, b in gen.batches(n, tr["batch"])]
        metrics, groups = _panel(tr["panel"], device)
        for _ in range(tr["warmup_passes"]):
            for s, y in views:
                _update(groups, s, y)
            _end_pass(metrics)
        sync()
        setup_s = time.perf_counter() - t0

        host_us, passes, held, traced, pass_ends = [], [], [], [], []
        trace_at, trace_n = tr["trace"]["start_batch"], tr["trace"]["batches"]
        samples = done = i = 0
        traced_from = None
        k1_before = _kernels.LAUNCHES[K1]
        with CompileCounter() as captures:
            t_start = time.perf_counter()
            while True:
                if tracer.wanted and done == trace_at:
                    tracer.start()
                    traced_from, sizes = done, []
                s, y = views[i]
                h0 = time.perf_counter()
                with tracer.range("evalbench.update"):
                    _update(groups, s, y)
                host_us.append((time.perf_counter() - h0) * 1e6)
                samples += s.numel()
                done += 1
                i += 1
                if tracer.active:
                    sizes.append(s.numel())
                    if done == traced_from + trace_n:
                        tracer.stop()
                        if tracer.record is not None:
                            traced = sizes
                        trace_at += len(views)
                if i == len(views):
                    with tracer.range("evalbench.compute"):
                        values, counts = _end_pass(metrics)
                    passes.append(values)
                    held.append(counts)
                    pass_ends.append(time.perf_counter() - t_start)
                    i = 0
                if time.perf_counter() - t_start >= seconds:
                    break
            if tracer.active:
                tracer.stop()
                if tracer.record is not None:
                    traced = sizes
            sync()
            window_s = time.perf_counter() - t_start
        memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        streaming = sum(isinstance(m, tm.StreamingBinaryAUROC) for m in metrics.values())
        buffered = sum(isinstance(m, BufferedExamplesMetric) for m in metrics.values())
        bins = {m.num_bins for m in metrics.values() if isinstance(m, tm.StreamingBinaryAUROC)}
        counters = {"k1_launches": _kernels.LAUNCHES[K1] - k1_before,
                    "streaming_updates": streaming * done,
                    "graph_captures": captures.programs,
                    "pass_end_s": pass_ends}
        del metrics, groups, views, scores, labels
        if cuda:
            torch.cuda.empty_cache()

        scores, labels = gen.click_eval_set(cfg, seed, device)
        want = ref.panel_values(tr["panel"], scores, labels, tr["batch"])
        readings = compare.panel_readings(passes, want)
        readings["count_gap"] = compare.count_gap(held, n) if passes else float("nan")

    record = {"panel_update_us": host_us, "pass_samples": n,
              "buffered_metrics": buffered, "streaming_metrics": streaming,
              "num_bins": max(bins) if bins else None, "traced_batch_sizes": traced,
              "passes": len(passes)}
    return Outcome(
        metrics={"samples_per_s": samples / window_s,
                 "update_us_p95": float(np.percentile(host_us, 95)),
                 "setup_s": setup_s},
        attempted=done, failed=0, checks=checks_from(readings, cell.limits),
        memory_peak_bytes=memory_peak, record=record, counters=counters)
