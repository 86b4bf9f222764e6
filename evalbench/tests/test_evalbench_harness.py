"""The harness's yardsticks and plumbing: cells found by name from new
files, the roofline counts, the trace reduction, the import guard and the
controls at small sizes."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from evalbench import guard, harness, roofline, spec, trace
from evalbench import traffic as gen

from evalbench.tests.evalbench_tiny import ROOT, tiny


def test_new_config_traffic_and_metric_are_found_without_edits(tmp_path):
    """A later change adds a configuration, a traffic mix, a cell's limits
    and a per-layer metric as new files and entries; the harness runs the
    cell and reads the metric, and no file that was there changes."""
    root = tmp_path / "checkout"
    shutil.copytree(Path(ROOT) / "evalbench", root / "evalbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (root / "evalbench").rglob("*") if p.is_file()}
    bench = spec.load_benchmark(ROOT)
    cfg = json.loads((Path(ROOT) / "evalbench/configs/criteo_dlrm_eval.json").read_text())
    cfg.update(name="ctr_small", samples=1 << 16)
    (root / "evalbench/configs/ctr_small.json").write_text(json.dumps(cfg))
    (root / "evalbench/traffic/ne_only.json").write_text(json.dumps({
        "batch": 2048, "weights": "unit", "warmup_passes": 1,
        "panel": [{"name": "ne", "metric": "BinaryNormalizedEntropy",
                   "inputs": ["scores", "labels"], "reference": "ne"}],
        "trace": {"start_batch": 2, "batches": 2}}))
    (root / "evalbench/limits/ctr_small.ne_only.json").write_text(json.dumps({"ne_rel": 1e-5, "count_gap": 0}))
    (root / "evalbench/layers/passes_done.py").write_text(
        "def read(record):\n    return record.get('passes') or None\n")
    bench["configs"].append({"name": "ctr_small", "source": "https://example.org/ctr",
                             "file": "evalbench/configs/ctr_small.json", "reduced": ["samples"],
                             "why": "test"})
    bench["workloads"].append({"name": "ctr_small.ne_only", "config": "ctr_small",
                               "traffic": "ne_only", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if "criteo_stream_pass" in m.get("workloads", ()):
            m["workloads"].append("ctr_small.ne_only")
    bench["per_layer"].append({"name": "passes_done", "unit": "passes", "better": "higher",
                               "source": "program_counter", "layer": "metric core and toolkit",
                               "moves": "samples_per_s", "workloads": ["ctr_small.ne_only"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.cell("ctr_small.ne_only", root=root)
    assert [m["name"] for m in cell.per_layer] == ["passes_done"]
    result = harness.run_cell(cell, 3, 1.0, False, "cpu", time.perf_counter())
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"samples_per_s", "update_us_p95", "setup_s"}
    assert spec.readers(cell)["passes_done"].read({"passes": 4}) == 4
    assert all(p.read_bytes() == b for p, b in before.items())


def test_every_cell_of_the_benchmark_loads():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        cell = spec.cell(w["name"])
        assert set(cell.limits) and spec.loop(cell).run
        assert set(spec.readers(cell)) == {m["name"] for m in cell.per_layer}
        moved = {m["moves"] for m in cell.per_layer}
        assert moved <= {m["name"] for m in cell.end_to_end}


def test_a_dotted_metric_reads_with_its_first_part_unless_it_has_its_own(tmp_path):
    layers = tmp_path / "evalbench" / "layers"
    layers.mkdir(parents=True)
    (layers / "device_idle_pct.py").write_text("")
    assert spec.reader_path(tmp_path, "device_idle_pct.lm") == layers / "device_idle_pct.py"
    (layers / "device_idle_pct.lm.py").write_text("")
    assert spec.reader_path(tmp_path, "device_idle_pct.lm") == layers / "device_idle_pct.lm.py"
    assert spec.reader_path(tmp_path, "step_mfu") == layers / "step_mfu.py"


def test_lm_flops_against_flop_counter():
    from torcheval_tpu_torch.models import TransformerLM
    from torcheval_tpu_torch.tools import count_flops

    for (v, d, h, f, layers, seq, batch) in ((97, 32, 4, 128, 2, 16, 3), (256, 64, 8, 96, 3, 24, 2)):
        model = TransformerLM(vocab_size=v, d_model=d, n_heads=h, n_layers=layers, d_ff=f,
                              max_len=seq, device="cpu", dtype=torch.float32)
        tokens = torch.zeros((batch, seq), dtype=torch.int64)
        dense = roofline.lm_forward_flops(v, d, f, layers, seq, batch, causal=False)
        assert count_flops(model, tokens) == dense
        causal = roofline.lm_forward_flops(v, d, f, layers, seq, batch)
        assert dense - causal == 2 * layers * batch * seq * seq * d


def test_gpt2_xl_step_flops():
    cfg = spec.cell("gpt2xl_eval").config
    flops = roofline.lm_forward_flops(cfg["vocab_size"], cfg["n_embd"], gen.d_ff(cfg),
                                      cfg["n_layer"], 1024, batch=8)
    assert abs(flops / 2.677e13 - 1) < 1e-3
    params = sum(int(torch.Size(s).numel()) for s in gen.lm_shapes(cfg).values())
    assert abs(params / 1.637e9 - 1) < 1e-3


def test_k1_and_bridge_bytes_by_hand():
    assert roofline.k1_bytes(65_536, 8192) == 65_536 * 4 * 2 + 8192 * 2 * 4 * 2
    assert roofline.k1_bytes(10, 4, tasks=3, weighted=True) == 3 * 10 * 12 + 3 * 4 * 2 * 4 * 2
    assert roofline.bridge_bytes(8192, 50_257) == 8192 * 50_257 * 2 + 8192 * 8
    assert roofline.curve_bytes(100, 2) == 100 * (4 + 4) * 2
    assert roofline.share_pct(1.0, 4.0) == 25.0 and roofline.share_pct(1.0, 0.0) is None


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def test_reduce_trace_attributes_and_finds_gaps():
    events = [
        _x("user_annotation", trace.WINDOW, -20, 120),
        _x("user_annotation", "evalbench.step", 0, 90),
        _x("user_annotation", "evalbench.metric_update", 50, 40),
        _x("cpu_op", "aten::mm", 5, 3),
        _x("cuda_runtime", "cudaLaunchKernel", 6, 1, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 60, 1, correlation=2),
        _x("kernel", "gemm", 10, 30, correlation=1),
        _x("kernel", "softmax", 70, 10, correlation=2),
        _x("kernel", "late", 95, 20, correlation=3),
    ]
    r = trace.reduce_trace(events)
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx((30 + 10 + 5) * 1e-6)
    assert r["range_device_s"]["evalbench.step"] == pytest.approx(40e-6)
    assert r["range_device_s"]["evalbench.metric_update"] == pytest.approx(10e-6)
    assert r["top_ops"][0] == ["gemm", pytest.approx(30e-6)]
    assert trace.extents(r, "evalbench.step") == [pytest.approx(70e-6)]
    assert trace.extents(r, "evalbench.metric_update") == [pytest.approx(10e-6)]
    assert trace.extents(r, "evalbench.forward") == [] and trace.extents(None, "x") == []
    gaps = [g for _, g in r["idle_gaps"]]
    assert gaps == sorted(gaps, reverse=True) and gaps[0] == pytest.approx(30e-6)
    assert r["idle_gaps"][0][0] == "evalbench.step"
    assert trace.reduce_trace(events[1:]) is None


def test_guard_compares_top_level_names(tmp_path):
    assert guard.banned_modules(["jax", "jax.numpy", "jaxlib.xla", "torcheval_tpu.metrics",
                                 "torcheval_tpu_torch.metrics", "flax", "jaxtyping"]) == [
        "flax", "jax", "jax.numpy", "jaxlib.xla", "torcheval_tpu.metrics"]
    assert guard.reference_imports() == []
    (tmp_path / "bad.py").write_text("import torch\nfrom torcheval_tpu_torch.ops import x\n"
                                     "import jax.numpy as jnp\nfrom . import ctr\n")
    assert guard.reference_imports(tmp_path) == ["bad.py: torcheval_tpu_torch.ops",
                                                 "bad.py: jax.numpy"]


def test_a_run_loads_nothing_banned_in_a_fresh_process():
    code = (
        "import sys, time, dataclasses\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from evalbench.tests.evalbench_tiny import tiny\n"
        "from evalbench import guard, harness, spec\n"
        "for name in ('criteo_stream_pass', 'gpt2xl_eval'):\n"
        "    r = harness.run_cell(tiny(spec.cell(name)), 1, 1.0, False, 'cpu', time.perf_counter())\n"
        "    assert r['correct'], r\n"
        "print(guard.violations())\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_a_card_exits_nonzero_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "evalbench/run.py", "--workload", "criteo_stream_pass",
                          "--seed", str(2 ** 31 + 5), "--seconds", "1"], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_run_without_the_program_exits_nonzero(tmp_path):
    shutil.copytree(Path(ROOT) / "evalbench", tmp_path / "evalbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(Path(ROOT) / "BENCHMARK.json", tmp_path)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "evalbench/run.py", "--workload", "gpt2xl_eval",
                          "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
                         cwd=tmp_path, env=env, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.parametrize("name", ("criteo_stream_pass", "criteo_exact_pass", "gpt2xl_eval"))
def test_control_fails_the_cell_limits(name, monkeypatch):
    """The control, at a size a test run holds, fails at least one of the
    cell's numbers under the cell's own limits (on the card it runs at
    the cell's size: ``evalbench/control.py``)."""
    from evalbench import control

    cell = tiny(spec.cell(name))
    if cell.config["loop"] == "panel_pass":
        cell.config["samples"] = 1 << 20
        readings = control.panel_control(cell, 3, "cpu")
    else:
        readings = control.lm_control(cell, 3, "cpu")
    assert any(not v <= cell.limits[k] for k, v in readings.items()), readings
