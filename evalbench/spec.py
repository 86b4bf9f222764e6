"""Find a cell's pieces by name.

``BENCHMARK.json`` at the checkout's root names every cell, configuration
and metric. Each piece is a file under ``evalbench/`` found by its name:

- ``configs/<config>.json`` (the path is the configuration's ``file``):
  the sizes as run, and ``loop``, the eval loop that runs it;
- ``traffic/<traffic>.json``: the traffic mix's parameters;
- ``limits/<cell>.json``: the limit of each number that decides
  ``correct`` in that cell;
- ``loops/<loop>.py``: an eval loop, with ``run(cell, ...)``;
- ``layers/<metric>.py``: a per-layer metric's reader, with
  ``read(record)``; a dotted name without a file of its own reads with
  the file of its first part.

A cell's per-layer metrics are those whose ``workloads`` list it, and
those without the key whose ``moves`` metric the cell reports.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, Tuple

ROOT = Path(__file__).resolve().parents[1]


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: Tuple[dict, ...]
    per_layer: Tuple[dict, ...]
    root: Path


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _for_cell(metric: dict, cell: str, reported=()) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return not reported or metric["moves"] in reported


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``, its files read."""
    root = Path(root)
    bench = load_benchmark(root)
    workloads = {w["name"]: w for w in bench["workloads"]}
    if name not in workloads:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(workloads)})")
    w = workloads[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((root / "evalbench" / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((root / "evalbench" / "limits" / f"{name}.json").read_text())
    e2e = tuple(m for m in bench["end_to_end"] if _for_cell(m, name))
    reported = {m["name"] for m in e2e}
    per_layer = tuple(m for m in bench["per_layer"] if _for_cell(m, name, reported))
    return Cell(name, w["chips"], w["config"], config, w["traffic"], traffic, limits,
                e2e, per_layer, root)


def _load(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def loop(c: Cell) -> ModuleType:
    """The eval loop that runs ``c``'s configuration."""
    name = c.config["loop"]
    return _load(c.root / "evalbench" / "loops" / f"{name}.py", f"evalbench_loop_{name}")


def reader_path(root: Path, metric: str) -> Path:
    """``layers/<metric>.py``, or for a dotted name without a file of its
    own (``device_idle_pct.lm``) the reader of its first part
    (``layers/device_idle_pct.py``): one quantity split by the end-to-end
    metric it moves keeps one reader."""
    layers = Path(root) / "evalbench" / "layers"
    own = layers / f"{metric}.py"
    return own if own.exists() or "." not in metric else layers / f"{metric.split('.')[0]}.py"


def readers(c: Cell) -> Dict[str, ModuleType]:
    """Each of ``c``'s per-layer metrics -> its reader module."""
    return {
        m["name"]: _load(reader_path(c.root, m["name"]),
                         "evalbench_layer_" + m["name"].replace(".", "_"))
        for m in c.per_layer
    }
