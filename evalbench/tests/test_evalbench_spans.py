"""The spans window: ``evalbench.spans.reduce_spans`` on a planted chrome
trace, the readers of the program's spans on a synthetic reduced record
(and None without one), an untraced run that opens no profiler and leaves
the recorder off, and the spans measurement on the tiny Criteo cells."""

from __future__ import annotations

import importlib.util

import pytest
import torch

from evalbench import spans, spec
from evalbench.tests.evalbench_tiny import tiny


def _reader(name):
    path = spec.reader_path(spec.ROOT, name)
    s = importlib.util.spec_from_file_location(f"evalbench_test_{name}", path)
    module = importlib.util.module_from_spec(s)
    s.loader.exec_module(module)
    return module


def _x(name, ts, dur, cat="user_annotation", correlation=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if correlation is not None:
        e["args"] = {"correlation": correlation}
    return e


def _planted():
    """One batch: two panel updates, K1 inside the first's accumulate, a
    kernel launched in each panel update and one after them, so the
    device idles from 10 to 85 (only the batch's range open), from 95 to
    245 (K1's wrapper innermost), from 255 to 306 (the second accumulate
    innermost) and from 310 to the window's end."""
    return [
        _x("evalbench.spans", 0, 1000),
        _x("evalbench.update", 10, 300),
        _x("torcheval.update_collection", 20, 200),
        _x("torcheval.plan/A", 25, 35),
        _x("torcheval.accumulate/A", 60, 90),
        _x("torcheval.k1", 70, 30),
        _x("torcheval.update_collection", 230, 60),
        _x("torcheval.plan/B", 231, 4),
        _x("torcheval.accumulate/B", 235, 45),
        _x("cudaLaunchKernel", 80, 2, "cuda_runtime", 1),
        _x("hist", 85, 10, "kernel", 1),
        _x("cudaLaunchKernel", 240, 2, "cuda_runtime", 2),
        _x("sum", 245, 10, "kernel", 2),
        _x("cudaLaunchKernel", 305, 1, "cuda_runtime", 3),
        _x("copy", 306, 4, "kernel", 3),
        _x("aten::add_", 240, 3, "cpu_op"),
    ]


def test_reduce_spans_attributes_spans_launches_and_idle_gaps():
    r = spans.reduce_spans(_planted())
    (batch,) = r["batches"]
    assert batch["update_us"] == 300 and batch["collections"] == 2
    assert batch["spans_us"] == {"torcheval.update_collection": 260, "torcheval.plan/A": 35,
                                 "torcheval.accumulate/A": 90, "torcheval.k1": 30,
                                 "torcheval.plan/B": 4, "torcheval.accumulate/B": 45}
    assert batch["k1_us"] == [30]
    assert batch["launches"] == 2  # the third kernel was launched after both panels
    idle = dict(r["idle_by_span"])
    assert idle == pytest.approx({"evalbench.update": (75 + 690) / 1e6, "torcheval.k1": 150 / 1e6,
                                  "torcheval.accumulate/B": 51 / 1e6})
    assert r["busy_s"] == pytest.approx(24 / 1e6)
    assert r["window_s"] == pytest.approx(990 / 1e6)  # from the first range on


def test_reduce_spans_without_the_window_is_none():
    assert spans.reduce_spans([e for e in _planted() if e["name"] != "evalbench.spans"]) is None


def _record():
    b = [
        {"update_us": 500.0, "collections": 2, "launches": 30, "k1_us": [40.0, 44.0],
         "spans_us": {"torcheval.update_collection": 480.0, "torcheval.plan/NE": 100.0,
                      "torcheval.plan/CTR": 20.0, "torcheval.accumulate/NE": 150.0,
                      "torcheval.accumulate/StreamingBinaryAUROC": 160.0, "torcheval.k1": 84.0,
                      "torcheval.update/BinaryAUROC": 70.0, "torcheval.update/Other": 9.0}},
        {"update_us": 700.0, "collections": 2, "launches": 34, "k1_us": [50.0, 60.0],
         "spans_us": {"torcheval.update_collection": 680.0, "torcheval.plan/NE": 200.0,
                      "torcheval.plan/CTR": 30.0, "torcheval.replay": 250.0, "torcheval.k1": 110.0,
                      "torcheval.update/BinaryAUROC": 90.0, "torcheval.update/BinaryAUPRC": 50.0}},
    ]
    return {"spans": {"batches": b, "idle_by_span": [], "window_s": 1.0, "busy_s": 0.1},
            "buffered_classes": ["BinaryAUROC", "BinaryAUPRC"],
            "buffer_growths": {"growths": 110, "passes": 2}}


@pytest.mark.parametrize("name, want", [
    ("plan_host_us", (120.0 + 230.0) / 2),
    ("accumulate_host_us", (310.0 + 250.0) / 2),
    ("k1_host_us", (44.0 + 50.0) / 2),
    ("panel_launches", 32),
    ("append_host_us", (70.0 + 140.0) / 2),
    ("growth_copies", 55.0),
])
def test_span_readers_read_the_spans_window(name, want):
    reader = _reader(name)
    assert reader.read(_record()) == pytest.approx(want)
    assert reader.read({"panel_update_us": [1.0], "trace": {}}) is None


@pytest.mark.parametrize("name", ("plan_host_us", "accumulate_host_us", "k1_host_us",
                                  "panel_launches", "append_host_us"))
def test_span_readers_find_nothing_in_a_program_without_the_spans(name):
    """A spans window over a program that opens no ``torcheval.*`` range
    (or only the fallback update ranges) reads None, never 0."""
    record = _record()
    for b in record["spans"]["batches"]:
        b.update(spans_us={}, k1_us=[], collections=0, launches=0)
    assert _reader(name).read(record) is None


def test_growth_copies_reads_a_counted_zero_and_none_without_a_counter():
    reader = _reader("growth_copies")
    assert reader.read({"buffer_growths": {"growths": 0, "passes": 3}}) == 0.0
    assert reader.read({"buffer_growths": None}) is None


def test_untraced_run_opens_no_profiler_and_leaves_the_recorder_off(tiny_cell, run_tiny,
                                                                    monkeypatch):
    from torcheval_tpu_torch import obs

    def refuse(*args, **kwargs):
        raise AssertionError("an untraced run opened the profiler")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(obs, "enable", refuse)
    result = run_tiny(tiny_cell("criteo_stream_pass"), seconds=0.5)
    assert result["correct"] and "breakdown" not in result
    assert not obs.enabled()


@pytest.mark.parametrize("name", ("criteo_stream_pass", "criteo_exact_pass"))
def test_spans_measurement_on_a_tiny_cell(name):
    from torcheval_tpu_torch import obs

    out = spans.measure(tiny(spec.cell(name)), 11, 1, torch.device("cpu"))
    (rep,) = out["repeats"]
    read = rep["readings"]
    assert not obs.enabled() and len(obs.recorder().log) == 0
    assert read["plan_host_us"] > 0 and read["panel_launches"] == 0  # no device on the CPU
    if name == "criteo_stream_pass":
        assert read["accumulate_host_us"] > 0 and read["k1_host_us"] > 0
        assert read["append_host_us"] is None and read["growth_copies"] == 0
    else:
        # 2^15 samples in batches of 4,096: capacities 4,096 -> 32,768,
        # three growths of each of five buffers a pass
        assert read["accumulate_host_us"] is None and read["k1_host_us"] is None
        assert read["append_host_us"] > 0 and read["growth_copies"] == 15
    assert 0.5 < rep["collection_over_update"] <= 1.0
