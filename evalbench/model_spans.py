"""The program's model spans on the card: device time launched inside each
``torcheval.*`` and ``evalbench.*`` range of a few profiled steps.

While its observability recorder is on and a profiler collects, the
program's MLA + MoE model opens a ``torch.profiler.record_function`` range
for each layer's attention (``torcheval.mla``) and for its expert layer's
routing (``torcheval.moe.route``), routed grouped products
(``torcheval.moe.experts``) and shared experts (``torcheval.moe.shared``);
the eval loop's steps sit in ``evalbench.step``. ``profile_steps`` runs a
few steps so, after the measured window, and ``reduce_model_spans`` puts
each device operation's time down to every such range open on the host
when it was launched (matched by correlation id, as
``evalbench.trace.reduce_trace`` matches them). The readers
``layers/{expert_share_pct, expert_roofline, mla_share_pct}.py`` read the
result under ``record["model_spans"]``; a program that opens no such range
gives them nothing to read.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, List, Optional

import torch

from evalbench.trace import _DEVICE_CATS, _merge, _open_idx

PREFIXES = ("torcheval.", "evalbench.")
ATTEMPTS = 3


def reduce_model_spans(events: List[dict]) -> Optional[dict]:
    """``range_device_s``: device seconds launched inside each range named
    with a ``PREFIXES`` prefix (an operation counts once a range name);
    ``busy_s``: the union of the device operations. None when the trace
    holds no device operation."""
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e and "dur" in e]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in xs
                   if e.get("cat") == "user_annotation" and e["name"].startswith(PREFIXES))
    starts = [s[0] for s in spans]
    launches = {e["args"]["correlation"]: float(e["ts"]) for e in xs
                if str(e.get("cat", "")).startswith("cuda_") and "correlation" in e.get("args", {})}
    per: dict = defaultdict(float)
    busy = []
    for e in xs:
        if e.get("cat") not in _DEVICE_CATS:
            continue
        a, dur = float(e["ts"]), float(e["dur"])
        busy.append((a, a + dur))
        host = launches.get(e.get("args", {}).get("correlation"))
        if host is None:
            continue
        for name in {spans[i][2] for i in _open_idx(spans, starts, host)}:
            per[name] += dur / 1e6
    if not busy:
        return None
    return {"range_device_s": dict(per),
            "busy_s": sum(b - a for a, b in _merge(busy)) / 1e6}


def profile_steps(step: Callable[[int], object], first: int, steps: int, device) -> Optional[dict]:
    """Run ``step(first)`` .. ``step(first + steps - 1)`` under a profiler
    with the program's recorder on (off and reset after), and reduce the
    trace; on a card a trace that held no device operation is taken
    again, up to ``ATTEMPTS`` times. ``steps`` is added to the result."""
    from torch.profiler import ProfilerActivity, profile

    from torcheval_tpu_torch import obs

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    for _ in range(ATTEMPTS if cuda else 1):
        sync()
        with profile(activities=activities) as prof:
            obs.enable()
            try:
                for k in range(first, first + steps):
                    step(k)
                sync()
            finally:
                obs.disable()
                obs.recorder().reset()
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                reduced = reduce_model_spans(json.load(f)["traceEvents"])
        if reduced is not None:
            return dict(reduced, steps=steps)
    return None
