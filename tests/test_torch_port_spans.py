"""The port's program spans in ``torch.profiler`` traces, the buffer
growth counter, and the Chrome exporter's clock.

- With the recorder off an ``update_collection`` opens no ``torcheval.*``
  profiler range and pushes no span frame.
- With it on, ``torcheval.update_collection`` holds a
  ``torcheval.plan/<Metric>`` and a ``torcheval.accumulate/<Metric>``
  range for each metric with a plan, K1's wrapper (``torcheval.k1``) runs
  inside the streaming AUROC's accumulate, and the causal frames parent
  the same way. The new spans record no event.
- ``metrics._buffer.GROWTHS`` counts what ``next_capacity`` implies, and
  the default registry shows it as ``buffers``; ``_fuse.graph_stats()``
  is its ``graphs`` source.
- ``obs.export_chrome_trace`` writes on the clock of a ``torch.profiler``
  chrome trace (``ts`` + ``baseTimeNanoseconds``): a span and an update
  start within ``CLOCK_SLACK_US`` of their profiler ranges (the median
  of ``CLOCK_RUNS`` runs). The test prints the largest offset of its
  runs; it runs on a card where there is one, decided inside the test.

This file imports no JAX, so it runs unchanged on a machine with a card.
"""

from __future__ import annotations

import json
import os
import statistics
import tempfile

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torcheval_tpu_torch.metrics as TM
from torcheval_tpu_torch import obs
from torcheval_tpu_torch.metrics import _buffer
from torcheval_tpu_torch.metrics._buffer import next_capacity
from torcheval_tpu_torch.metrics.toolkit import update_collection
from torcheval_tpu_torch.obs import trace as obs_trace

CPU = "cpu"
CLOCK_SLACK_US = 200.0
CLOCK_RUNS = 20
PLANNED = ("BinaryNormalizedEntropy", "WeightedCalibration", "StreamingBinaryAUROC",
           "StreamingBinaryAUPRC", "ClickThroughRate")


@pytest.fixture
def recording():
    obs.enable()
    obs.recorder().reset()
    try:
        yield obs.recorder()
    finally:
        obs.disable()
        obs.recorder().reset()


def _criteo_panel(device):
    """The stream cell's panel: four metrics on (scores, labels), CTR on
    the labels alone."""
    pair = {
        "ne": TM.BinaryNormalizedEntropy(device=device),
        "calibration": TM.WeightedCalibration(device=device),
        "auroc": TM.StreamingBinaryAUROC(num_bins=64, device=device),
        "auprc": TM.StreamingBinaryAUPRC(num_bins=64, device=device),
    }
    return pair, {"ctr": TM.ClickThroughRate(device=device)}


def _batch(device, n=512, seed=3):
    g = torch.Generator().manual_seed(seed)
    s = torch.rand(n, generator=g)
    y = (torch.rand(n, generator=g) < s).float()
    return s.to(device), y.to(device)


def _update(pair, single, s, y):
    update_collection(pair, s, y)
    update_collection(single, y)


def _chrome(prof):
    """(events, baseTimeNanoseconds) of a finished profile's chrome trace."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    return trace["traceEvents"], int(trace.get("baseTimeNanoseconds", 0))


def _ranges(events, prefix="torcheval."):
    return [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e["name"].startswith(prefix)]


def _inside(inner, outer):
    return (float(outer["ts"]) <= float(inner["ts"])
            and float(inner["ts"]) + float(inner["dur"]) <= float(outer["ts"]) + float(outer["dur"]))


def test_recorder_off_opens_no_range_and_pushes_no_frame(monkeypatch):
    assert not obs.enabled()
    pair, single = _criteo_panel(CPU)
    s, y = _batch(CPU)
    _update(pair, single, s, y)  # warm

    def no_push(name):
        raise AssertionError(f"span {name!r} pushed with the recorder off")

    monkeypatch.setattr(obs_trace, "push", no_push)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _update(pair, single, s, y)
    events, _ = _chrome(prof)
    assert _ranges(events) == []


def test_recorder_on_nests_plan_accumulate_and_k1_ranges(recording, monkeypatch):
    pair, single = _criteo_panel(CPU)
    s, y = _batch(CPU)
    _update(pair, single, s, y)  # warm
    recording.reset()
    frames = []
    push = obs_trace.push

    def keep(name):
        frame = push(name)
        frames.append(frame)
        return frame

    monkeypatch.setattr(obs_trace, "push", keep)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _update(pair, single, s, y)
    events, _ = _chrome(prof)
    ranges = _ranges(events)
    panels = [r for r in ranges if r["name"] == "torcheval.update_collection"]
    assert len(panels) == 2
    for cls in PLANNED:
        for kind in ("plan", "accumulate"):
            mine = [r for r in ranges if r["name"] == f"torcheval.{kind}/{cls}"]
            assert len(mine) == 1, (kind, cls)
            assert any(_inside(mine[0], p) for p in panels)
    k1 = [r for r in ranges if r["name"] == "torcheval.k1"]
    assert len(k1) == 2  # the AUROC's and the AUPRC's
    auroc = next(r for r in ranges if r["name"] == "torcheval.accumulate/StreamingBinaryAUROC")
    assert sum(_inside(r, auroc) for r in k1) == 1
    # every range opened once: the frame and its profiler range are one
    assert sorted(r["name"] for r in ranges) == sorted(f.name for f in frames)

    # the causal frames: plans and accumulates are children of their
    # panel, K1 of the streaming AUROC's accumulate
    by_name = {}
    for f in frames:
        by_name.setdefault(f.name, []).append(f)
    panel_ids = {f.span_id for f in by_name["torcheval.update_collection"]}
    assert all(f.parent_id is None for f in by_name["torcheval.update_collection"])
    for cls in PLANNED:
        for kind in ("plan", "accumulate"):
            assert by_name[f"torcheval.{kind}/{cls}"][0].parent_id in panel_ids
    parents = {f.parent_id for f in by_name["torcheval.k1"]}
    assert by_name["torcheval.accumulate/StreamingBinaryAUROC"][0].span_id in parents
    assert by_name["torcheval.accumulate/StreamingBinaryAUPRC"][0].span_id in parents

    # one event a panel; the new spans record none
    assert [e.kind for e in recording.log.tail()] == ["update", "update"]


def test_fallback_metric_keeps_its_update_range(recording):
    metrics = {"auroc": TM.BinaryAUROC(device=CPU), "ne": TM.BinaryNormalizedEntropy(device=CPU)}
    s, y = _batch(CPU)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        update_collection(metrics, s, y)
    events, _ = _chrome(prof)
    ranges = _ranges(events)
    panel = next(r for r in ranges if r["name"] == "torcheval.update_collection")
    update = next(r for r in ranges if r["name"] == "torcheval.update/BinaryAUROC")
    assert _inside(update, panel)
    assert [r["name"] for r in ranges].count("torcheval.accumulate/BinaryNormalizedEntropy") == 1
    assert not any(r["name"] == "torcheval.accumulate/BinaryAUROC" for r in ranges)


def test_obs_span_opens_one_profiler_range(recording):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("eval-epoch"):
            torch.ones(4).add_(1)
    events, _ = _chrome(prof)
    assert [e["name"] for e in _ranges(events, "eval-epoch")] == ["eval-epoch"]
    assert [e.kind for e in recording.log.tail()] == ["span"]


def _expected_growth(batches, n, elem_bytes, buffers):
    """Growths and bytes copied by appending ``batches`` batches of ``n``
    samples to empty buffers, the first allocation not counted."""
    growths = copied = 0
    cap = next_capacity(n)
    for k in range(2, batches + 1):
        if k * n > cap:
            growths += 1
            copied += cap * elem_bytes
            cap = next_capacity(k * n)
    return growths * buffers, copied * buffers


@pytest.mark.parametrize("recorder_on", (False, True))
def test_growth_counter_counts_what_next_capacity_implies(recorder_on):
    before = obs.default_registry().read()["buffers"]
    assert before == _buffer.growth_counts()
    m = TM.BinaryAUROC(device=CPU)  # three float32 buffers
    if recorder_on:
        obs.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for k in range(20):
                s, y = _batch(CPU, n=1000, seed=k)
                m.update(s, y)
    finally:
        obs.disable()
        obs.recorder().reset()
    after = obs.default_registry().read()["buffers"]
    growths, copied = _expected_growth(20, 1000, 4, 3)
    assert (growths, copied) == (15, 3 * 4 * (1024 + 2048 + 4096 + 8192 + 16384))
    assert after["growths"] - before["growths"] == growths
    assert after["growth_bytes"] - before["growth_bytes"] == copied
    grows = _ranges(_chrome(prof)[0], "torcheval.buffer.grow")
    assert len(grows) == (growths if recorder_on else 0)
    assert "torcheval_tpu_buffers_growths" in obs.render_prometheus()
    assert "[buffers]" in obs.format_report()


def test_graph_counter_is_the_graphs_source(monkeypatch):
    """The default registry's ``graphs`` source is ``_fuse.graph_stats()``:
    captures, replays and the unbucketed groups run eagerly by reason. An
    unbucketed group's first sighting (CPU states standing in for CUDA
    ones, donation on) counts ``eager_first_sighting`` and captures
    nothing."""
    from torcheval_tpu_torch import config
    from torcheval_tpu_torch.metrics import _fuse

    before = obs.default_registry().read()["graphs"]
    assert before == _fuse.graph_stats()
    assert set(before) == {"captures", "replays", "graphs", "pools"} | {
        f"eager_{r}" for r in ("first_sighting", "over_bytes", "budget", "capture_failed", "unfit")}
    monkeypatch.setattr(_fuse, "_GRAPH_DEVICE_TYPE", CPU)
    for name in ("_SIGHTINGS", "_BY_STATE"):
        monkeypatch.setattr(_fuse, name, {})
    monkeypatch.setattr(_fuse, "_stream_id", lambda index: 7)
    pair, _ = _criteo_panel(CPU)
    with config.update_donation(True):
        update_collection(pair, *_batch(CPU))
    after = obs.default_registry().read()["graphs"]
    assert after["eager_first_sighting"] - before["eager_first_sighting"] == 1
    assert (after["captures"], after["replays"]) == (before["captures"], before["replays"])
    assert "torcheval_tpu_graphs_eager_first_sighting" in obs.render_prometheus()
    assert "[graphs]" in obs.format_report()


def _clock_offsets(device):
    """Start of an ``obs.span`` and of an ``update_collection`` in the
    program's Chrome export minus the start of their profiler ranges, µs."""
    pair, _ = _criteo_panel(device)
    s, y = _batch(device)
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    obs.recorder().reset()
    with profile(activities=activities) as prof:
        with obs.span("clock-probe"):
            update_collection(pair, s, y)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
    events, base_ns = _chrome(prof)
    mine = {e["name"]: float(e["ts"]) for e in obs.export_chrome_trace()["traceEvents"]
            if e.get("ph") == "X"}
    theirs = {e["name"]: float(e["ts"]) + base_ns / 1e3 for e in _ranges(events, "")}
    return {
        "span": mine["span/clock-probe"] - theirs["clock-probe"],
        "update_collection": (mine["update/update_collection"]
                              - theirs["torcheval.update_collection"]),
    }


def test_chrome_export_shares_the_profiler_clock(recording):
    device = "cuda" if torch.cuda.is_available() else CPU
    pair, _ = _criteo_panel(device)
    update_collection(pair, *_batch(device))  # warm-up call
    runs = [_clock_offsets(device) for _ in range(CLOCK_RUNS)]
    worst = {name: max(abs(r[name]) for r in runs) for name in runs[0]}
    typical = {name: statistics.median(abs(r[name]) for r in runs) for name in runs[0]}
    print(f"\nclock offset over {CLOCK_RUNS} runs on {device} "
          f"({torch.cuda.get_device_name(0) if device == 'cuda' else 'cpu'}), "
          f"|program - profiler| us: largest {worst}, median {typical}")
    # the median: one run preempted between its two stamps (tests run
    # beside others) says nothing of the clocks, which would differ by far
    # more than the slack if they were not one
    assert max(typical.values()) <= CLOCK_SLACK_US, runs


def test_chrome_export_falls_back_to_the_monotonic_clock():
    event = {"kind": "span", "name": "x", "seconds": 0.001, "t_mono": 5.0, "t_wall": 0.0}
    (slice_,) = [e for e in obs.export_chrome_trace([event])["traceEvents"] if e["ph"] == "X"]
    assert slice_["ts"] == pytest.approx(5.0e6 - 1e3)
    event["t_wall"] = 1.7e9
    (slice_,) = [e for e in obs.export_chrome_trace([event])["traceEvents"] if e["ph"] == "X"]
    assert slice_["ts"] == pytest.approx(1.7e15 - 1e3)
