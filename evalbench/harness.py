"""One run of one cell, up to its result line.

``run_cell`` hands the cell to its eval loop (``loops/<loop>.py``), which
sets up, warms up, measures for ``seconds``, closes the window, reads the
memory peak, frees the program's state and compares what the timed path
produced with the plain reference. A traced run then reads each per-layer
metric of the cell with its reader (``layers/<metric>.py``); a reader that
finds nothing returns None and the metric is left out of the line.

The look for a card is not here but in ``run.py``, so the CPU tests can
drive every other part of a run.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List

from evalbench import spec
from evalbench.trace import Tracer


@dataclass
class Check:
    """One number compared with the reference, beside its limit: it passes
    when ``value <= limit`` (an exact comparison has the limit 0)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclass
class Outcome:
    """What an eval loop hands back."""

    metrics: Dict[str, float]
    attempted: int
    failed: int
    checks: List[Check]
    memory_peak_bytes: int
    record: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)


def checks_from(readings: Dict[str, float], limits: dict) -> List[Check]:
    """A check for each reading against the limit of the same name; a
    reading without a limit cannot pass."""
    return [Check(k, float(v), float(limits.get(k, float("-inf")))) for k, v in readings.items()]


def run_cell(c: spec.Cell, seed: int, seconds: float, trace: bool, device, t0: float) -> dict:
    """Run ``c`` once and return its result, keys in the order printed."""
    tracer = Tracer(bool(trace))
    tracer.warm(device)
    out: Outcome = spec.loop(c).run(c, seed=seed, seconds=seconds, tracer=tracer,
                                    device=device, t0=t0)
    units = {m["name"]: m["unit"] for m in c.end_to_end + c.per_layer}
    if trace:
        record = dict(out.record, trace=tracer.record)
        values = {name: reader.read(record) for name, reader in spec.readers(c).items()}
    else:
        values = {m["name"]: out.metrics.get(m["name"]) for m in c.end_to_end}
    metrics = {k: {"value": v, "unit": units[k]} for k, v in values.items() if v is not None}
    dev = device_info(device, out.memory_peak_bytes)
    result = {
        "correct": bool(out.checks) and all(ch.ok for ch in out.checks),
        "attempted": out.attempted,
        "failed": out.failed,
        "metrics": metrics,
        "device": dev,
    }
    if trace and tracer.record is not None:
        dev["busy_s"] = tracer.record["busy_s"]
        dev["window_s"] = tracer.record["window_s"]
        result["breakdown"] = {"device_ops": tracer.record["top_ops"],
                               "idle_gaps": tracer.record["idle_gaps"]}
    if torch_cuda(device):
        from evalbench import roofline

        result["card"] = {"power_limit_w": roofline.power_limit_w()}
    if out.counters:
        result["counters"] = out.counters
    result["checks"] = {ch.name: {"value": ch.value, "limit": ch.limit} for ch in out.checks}
    return result


def device_info(device, memory_peak_bytes: int) -> dict:
    import torch

    if torch_cuda(device):
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
                "memory_peak_bytes": int(memory_peak_bytes)}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": int(memory_peak_bytes)}


def torch_cuda(device) -> bool:
    import torch

    return torch.device(device).type == "cuda"


def check_lines(result: dict) -> List[str]:
    """The numbers compared, one a line, each beside its limit."""
    return [f"check {k}: {v['value']!r} limit {v['limit']!r} "
            f"{'ok' if v['value'] <= v['limit'] else 'FAIL'}" for k, v in result["checks"].items()]


def dumps(result: dict) -> str:
    return json.dumps(result, allow_nan=True)
