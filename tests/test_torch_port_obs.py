"""``torcheval_tpu_torch.obs`` against the JAX package's ``obs``: twins of
``tests/metrics/test_observability.py``, ``test_tracing.py``,
``test_flight_watchdog.py`` and ``test_monitor_server.py``.

Each twin feeds the same call sequence, with the same seeded numpy
inputs, to both packages with their recorders on, and compares what they
record: event kinds, metric names, step cursors, the span tree's shape,
flow ids, ``SyncEvent`` provenance and payload bytes, Prometheus family
and label sets, ``/healthz`` layouts and flight-ring verdicts.

Compile events and every ``seconds`` are left out of the comparisons:
the JAX package's compile event is an XLA program demand, the port's a
CUDA-graph capture (none happen on the CPU without the emulated graphs
below), and durations are wall time. The data-quality, admission and
wire-ladder sources exist only in the JAX package so far (ROADMAP A5b,
A7, A8): their Prometheus families are left out, and the port's sources
read empty.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torcheval_tpu
import torcheval_tpu_torch
# _fuse's graph path on CPU tensors: a capture then happens on the CPU
from tests.test_torch_port_fuse import emulated_graphs  # noqa: F401 — a fixture

NUM_CLASSES = 5
_DROP_FIELDS = {"t_mono", "t_wall", "tid", "trace", "span", "parent", "seconds", "schema", "flight"}


class _Pkg:
    """One package's observability surface, addressed the same way."""

    def __init__(self, name):
        self.name = name
        root = torcheval_tpu if name == "jax" else torcheval_tpu_torch
        base = root.__name__
        imp = __import__
        self.config = imp(f"{base}.config", fromlist=["x"])
        self.obs = imp(f"{base}.obs", fromlist=["x"])
        self.flight = imp(f"{base}.obs.flight", fromlist=["x"])
        self.hist = imp(f"{base}.obs.hist", fromlist=["x"])
        self.trace = imp(f"{base}.obs.trace", fromlist=["x"])
        self.monitor = imp(f"{base}.obs.monitor", fromlist=["x"])
        self.watchdog = imp(f"{base}.obs.watchdog", fromlist=["x"])
        self.server = imp(f"{base}.obs.server", fromlist=["x"])
        self.export = imp(f"{base}.obs.export", fromlist=["x"])
        self.M = imp(f"{base}.metrics", fromlist=["x"])
        self.toolkit = imp(f"{base}.metrics.toolkit", fromlist=["x"])
        self.dist = imp(f"{base}.distributed", fromlist=["x"])
        self.res = imp(f"{base}.resilience", fromlist=["x"])
        self.elastic = imp(f"{base}.elastic", fromlist=["x"])
        self.tu = imp(f"{base}.utils.test_utils", fromlist=["x"])
        if name == "jax":
            self.arr = lambda a: jnp.asarray(a)
            self.kw = {}
            self.devices = lambda n: jax.devices("cpu")[:1] * n
        else:
            self.arr = lambda a: torch.from_numpy(np.array(a, copy=True))
            self.kw = {"device": "cpu"}
            self.devices = lambda n: ["cpu"] * n

    def metric(self, cls, *args, **kwargs):
        return getattr(self.M, cls)(*args, **{**self.kw, **kwargs})

    def local_group(self, n):
        return self.dist.LocalReplicaGroup(self.devices(n))

    def clean(self):
        self.obs.recorder().reset()
        self.hist.reset()
        self.flight.FLIGHT.reset()


PKGS = {"jax": _Pkg("jax"), "port": _Pkg("port")}


@contextlib.contextmanager
def _recording(p, **kwargs):
    p.clean()
    with p.config.observability(**kwargs):
        yield p.obs.recorder()
    p.flight.FLIGHT.reset()


def _label(e):
    d = e if isinstance(e, dict) else e.as_dict()
    return d.get("metric") or d.get("name") or d.get("reason") or d.get("op") or ""


def _stream(events, drop_kinds=("compile",)):
    """Events as comparable tuples: the payload without timings and ids,
    the kind and label of the event it parents to, and its trace's order
    of first appearance. Flow ids are per-thread ordinals that earlier
    syncs on the same thread have advanced, so they compare by order of
    first appearance too."""
    by_span = {e.span: e for e in events if e.span is not None}
    traces, flows = {}, {}
    out = []
    for e in events:
        if e.kind in drop_kinds:
            continue
        payload = {k: v for k, v in e.as_dict().items() if k not in _DROP_FIELDS}
        if payload.get("flow"):
            payload["flow"] = flows.setdefault(payload["flow"], len(flows) + 1)
        parent = by_span.get(e.parent)
        where = (parent.kind, _label(parent)) if parent is not None else e.parent is not None
        trace = traces.setdefault(e.trace, len(traces)) if e.trace is not None else None
        out.append((payload, where, trace))
    return out


def _per_rank(events):
    ranks = {}
    for e in events:
        ranks.setdefault(e.tid, []).append(e)
    return sorted(ranks.values(), key=lambda evs: [e.rank for e in evs if e.rank is not None][:1])


def _twin(scenario, **kwargs):
    """Run ``scenario(p)`` in both packages with their recorders on; return
    {name: (result, events)}."""
    out = {}
    for name, p in PKGS.items():
        with _recording(p, **kwargs) as rec:
            result = scenario(p)
            events = rec.log.tail()
        out[name] = (result, events)
    return out


def _batches(seed, n=3, rows=16):
    rng = np.random.default_rng(seed)
    return [
        (rng.random((rows, NUM_CLASSES), np.float32), rng.integers(0, NUM_CLASSES, rows))
        for _ in range(n)
    ]


# ------------------------------------------------------- pure modules, both


def test_trace_stacks_flows_and_error_paths_match():
    for p in PKGS.values():
        t = p.trace
        t.clear_error_stack()
        with t.Scope("outer") as outer:
            with t.Scope("inner") as inner:
                assert inner.parent_id == outer.span_id
                assert inner.trace_id == outer.trace_id
                assert t.trace_path() == "outer > inner"
                t.annotate(bucket=64)
                assert inner.annotations == {"bucket": 64}
        t.annotate(bucket=1)  # no-op outside a span
        assert t.current() is None
        with pytest.raises(ValueError):
            with t.Scope("a"):
                with t.Scope("b"):
                    raise ValueError("x")
        assert t.last_error_stack() == ["a", "b"]
        flows = []
        th = threading.Thread(target=lambda: flows.extend(t.next_flow_id() for _ in range(3)))
        th.start()
        th.join(timeout=10)
        assert flows == [1, 2, 3]
        t.clear_error_stack()


def test_latency_histograms_bucket_merge_and_quantiles_match():
    rng = np.random.default_rng(3)
    samples = [float(s) for s in rng.exponential(2e-3, 200)]
    hs = {}
    for name, p in PKGS.items():
        a, b = p.hist.LatencyHistogram(), p.hist.LatencyHistogram()
        for i, s in enumerate(samples):
            (a if i % 2 else b).observe(s)
        merged = p.hist.LatencyHistogram().merge(a).merge(b)
        hs[name] = (merged.as_dict(), [merged.quantile(q) for q in (0.5, 0.9, 0.99)],
                    [p.hist.bucket_index(s) for s in (0.0, 1e-6, 3e-6, 1.0, 1e9)])
    assert hs["jax"] == hs["port"]
    with pytest.raises(ValueError):
        PKGS["port"].hist.LatencyHistogram.from_dict({"counts": [0] * 3})


def test_ewma_and_monitor_alerts_match():
    def run(p):
        mon = p.monitor.Monitor(
            slos=(p.monitor.SloSpec("retries", "sync.retries", "max", 0.5),),
            z_threshold=3.0, warmup=4, cooldown=0.0,
        )
        zs = [mon.observe("computed/x", v) for v in [1.0, 1.1, 0.9, 1.0, 1.05, 9.0, 1.0]]
        return zs, sorted(a["alert"] for a in mon.active_alerts()), mon.counters()

    assert run(PKGS["jax"]) == run(PKGS["port"])


def test_flight_diff_verdicts_match_on_the_same_rings():
    now = time.time()

    def rec(seq, op, state, rank, age=0.0):
        return {"seq": seq, "op": op, "state": state, "rank": rank, "t_issued": now - age,
                "t_enqueued": now - age, "attempts": 1}

    cases = [
        {0: [rec(1, "allgather_object", "completed", 0), rec(2, "allgather_array", "issued", 0)],
         1: [rec(1, "allgather_object", "completed", 1), rec(2, "allgather_array", "completed", 1)]},
        {0: [rec(1, "allgather_object", "completed", 0)],
         1: [rec(1, "allgather_array", "completed", 1)]},
        {0: [rec(1, "allgather_object", "issued", 0, age=9.0)],
         1: [rec(1, "allgather_object", "issued", 1, age=9.0)]},
        {0: [rec(1, "allgather_object", "completed", 0)],
         1: [rec(1, "allgather_object", "completed", 1)]},
    ]
    for case in cases:
        verdicts = []
        for p in PKGS.values():
            d = p.flight.diff_flight_rings(case, stall_after=5.0)
            verdicts.append((d.ok, d.stalled_rank, d.stalled_seq, d.stalled_op,
                             d.diverged_rank, d.divergence_seq, d.last_completed))
        assert verdicts[0] == verdicts[1]


def test_event_schema_round_trips_across_packages():
    for src, dst in (("jax", "port"), ("port", "jax")):
        s, d = PKGS[src].obs, PKGS[dst].obs
        for cls in ("UpdateEvent", "SyncEvent", "RetryEvent", "SnapshotEvent", "RestoreEvent",
                    "CompileEvent", "SpanEvent", "StallEvent", "AlertEvent", "MemoryEvent"):
            ev = getattr(s, cls)(step=3, rank=1)
            back = d.event_from_dict(json.loads(json.dumps(ev.as_dict())))
            assert type(back).__name__ == cls
            assert back.as_dict() == ev.as_dict()
        assert d.SCHEMA_VERSION == s.SCHEMA_VERSION
        future = d.event_from_dict({"kind": "update", "metric": "M", "from_the_future": 1})
        assert future.metric == "M"


# ------------------------------------------------- recorder on, both packages


def test_recorder_off_by_default_records_nothing():
    for p in PKGS.values():
        p.clean()
        assert not p.config.observability_enabled()
        m = p.metric("MulticlassAccuracy")
        x, y = _batches(0, n=1)[0]
        m.update(p.arr(x), p.arr(y))
        m.compute()
        assert p.obs.recorder().log.total == 0
        assert "obs_step" not in m.__dict__


def _core_scenario(p):
    rec = p.obs.recorder()
    batches = _batches(1)
    rec.set_step(3)
    m = p.metric("MulticlassAccuracy")
    m.update(p.arr(batches[0][0]), p.arr(batches[0][1]))
    step_stamp = m.obs_step
    m.compute()
    rec.set_step(4)
    panel = {
        "acc": p.metric("MulticlassAccuracy"),
        "f1": p.metric("MulticlassF1Score", num_classes=NUM_CLASSES, average="macro"),
        "cm": p.metric("MulticlassConfusionMatrix", NUM_CLASSES),
    }
    with p.obs.span("eval-epoch"):
        for x, y in batches:
            p.toolkit.update_collection(panel, p.arr(x), p.arr(y))
        reps = []
        for r in range(4):
            s = p.metric("Sum")
            s.update(p.arr(np.float32(r + 1)))
            reps.append(s)
        value = float(np.asarray(p.toolkit.sync_and_compute(reps, p.local_group(4))))
        coll = [{"acc": p.metric("MulticlassAccuracy"), "mean": p.metric("Mean")} for _ in range(4)]
        for r, c in enumerate(coll):
            x, y = batches[r % 3]
            c["acc"].update(p.arr(x), p.arr(y))
            c["mean"].update(p.arr(x[:, 0]))
        p.toolkit.sync_and_compute_collection(coll, p.local_group(4))
    m.reset()
    cleared = "obs_step" not in m.__dict__
    m.update(p.arr(batches[1][0]), p.arr(batches[1][1]))
    m.load_state_dict(m.state_dict())
    return step_stamp, cleared, "obs_step" not in m.__dict__, value


def test_update_compute_panel_sync_and_span_streams_match():
    runs = _twin(_core_scenario)
    (jres, jev), (tres, tev) = runs["jax"], runs["port"]
    assert jres == tres == (3, True, True, 10.0)
    assert _stream(tev) == _stream(jev)
    syncs = [e for e in tev if e.kind == "sync"]
    assert len(syncs) == 2 and all(e.sent_bytes > 0 and e.recv_bytes > 0 for e in syncs)
    assert syncs[1].flow == syncs[0].flow + 1


def _fault_scenario(p):
    out = []
    dead = p.res.ResilientGroup(
        p.tu.FaultInjectionGroup(p.local_group(4), dead_ranks={2}),
        timeout=2.0, policy="quorum",
    )
    reps = [p.metric("Sum") for _ in range(4)]
    for r, s in enumerate(reps):
        s.update(p.arr(np.float32(r + 1)))
    synced = p.toolkit.get_synced_metric(reps, dead)
    out.append((tuple(synced.sync_provenance.ranks), float(np.asarray(synced.compute()))))
    transient = p.res.ResilientGroup(
        p.tu.FaultInjectionGroup(p.local_group(4), [p.tu.FaultSpec(0, "transient")]),
        timeout=2.0, retries=2, policy="quorum", backoff_base=0.001, backoff_max=0.002,
    )
    synced = p.toolkit.get_synced_metric(reps, transient)
    out.append((tuple(synced.sync_provenance.ranks), float(np.asarray(synced.compute()))))
    raising = p.res.ResilientGroup(
        p.tu.FaultInjectionGroup(p.local_group(4), dead_ranks={1}),
        timeout=2.0, retries=0, policy="raise",
    )
    with pytest.raises(p.res.SyncTimeoutError):
        p.toolkit.get_synced_metric(reps, raising)
    return out


def test_fault_injection_retry_and_sync_streams_match():
    runs = _twin(_fault_scenario)
    assert runs["jax"][0] == runs["port"][0]
    jev, tev = runs["jax"][1], runs["port"][1]
    assert _stream(tev) == _stream(jev)
    kinds = [e.kind for e in tev]
    assert "retry" in kinds and "sync" in kinds and "span" in kinds
    degraded = [e for e in tev if e.kind == "sync" and e.degraded]
    assert degraded and degraded[0].ranks == (0, 1, 3)


def _elastic_scenario(p, directory):
    panel = {"acc": p.metric("MulticlassAccuracy"), "cm": p.metric("MulticlassConfusionMatrix", NUM_CLASSES)}
    session = p.elastic.ElasticSession(panel, directory, interval=2)
    for step, (x, y) in enumerate(_batches(2, n=4)):
        if session.fence(step):
            p.toolkit.update_collection(panel, p.arr(x), p.arr(y))
            session.step_done(step)
    session.close()
    cursor = p.obs.recorder().step_cursor
    fresh = {"acc": p.metric("MulticlassAccuracy"), "cm": p.metric("MulticlassConfusionMatrix", NUM_CLASSES)}
    again = p.elastic.ElasticSession(fresh, directory, interval=2)
    result = again.restore()
    again.close()
    snaps = p.obs.default_registry().read()["snapshots"]
    return cursor, result.step, p.obs.recorder().step_cursor, snaps["restores"] >= 1


def test_snapshot_and_restore_streams_match(tmp_path):
    runs = {}
    for name, p in PKGS.items():
        with _recording(p) as rec:
            res = _elastic_scenario(p, str(tmp_path / name))
            runs[name] = (res, rec.log.tail())
    assert runs["jax"][0] == runs["port"][0] == (4, 4, 4, True)
    assert _stream(runs["port"][1]) == _stream(runs["jax"][1])
    kinds = [e.kind for e in runs["port"][1]]
    assert kinds.count("snapshot") == 2 and kinds.count("restore") == 1


def _threadworld_scenario(p):
    def body(g):
        rg = p.res.ResilientGroup(g, timeout=20.0, policy="quorum")
        coll = {"acc": p.metric("MulticlassAccuracy"), "ctr": p.metric("ClickThroughRate")}
        x, y = _batches(10 + g.rank, n=1)[0]
        coll["acc"].update(p.arr(x), p.arr(y))
        coll["ctr"].update(p.arr((y % 2).astype(np.float32)))
        for _ in range(2):
            p.toolkit.sync_and_compute_collection(coll, rg)
        merged = p.obs.gather_observability(g)
        traces = p.obs.gather_traces(g)
        return merged["ranks"], sorted(traces["per_rank"]), sorted(traces["latency"])

    return p.tu.ThreadWorld(4, timeout=30.0).run(body)


def test_threadworld_sync_streams_flows_and_gathers_match():
    runs = _twin(_threadworld_scenario)
    assert runs["jax"][0] == runs["port"][0]
    for ranks, per_rank, _ in runs["port"][0]:
        assert ranks == per_rank == [0, 1, 2, 3]
    jranks, tranks = _per_rank(runs["jax"][1]), _per_rank(runs["port"][1])
    assert len(tranks) == 4
    assert [_stream(evs) for evs in tranks] == [_stream(evs) for evs in jranks]
    flows = {}
    for evs in tranks:
        for e in evs:
            if e.kind == "sync":
                flows.setdefault(e.flow, set()).add(e.rank)
    assert flows == {1: {0, 1, 2, 3}, 2: {0, 1, 2, 3}}
    trace = PKGS["port"].export.export_chrome_trace(runs["port"][1])
    arrows = [r for r in trace["traceEvents"] if r.get("cat") == "sync-flow"]
    jtrace = PKGS["jax"].export.export_chrome_trace(runs["jax"][1])
    jarrows = [r for r in jtrace["traceEvents"] if r.get("cat") == "sync-flow"]
    assert len(arrows) == len(jarrows) == 8


def test_gathers_reject_local_replica_groups_like_jax():
    for p in PKGS.values():
        for fn in (p.obs.gather_observability, p.obs.gather_traces):
            with pytest.raises(TypeError, match="rank-per-process"):
                fn(p.local_group(2))


# --------------------------------------------------------------- flight + watchdog


def _first_trip(wd, run):
    """Run ``run()`` on a thread and keep the watchdog's FIRST trip: when
    the slow rank resumes, its peers' next collective may still be older
    than the deadline and trip it again, replacing ``last_trip``."""
    box = {}

    def target():
        try:
            box["out"] = run()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            box["error"] = e

    t = threading.Thread(target=target)
    t.start()
    while t.is_alive():
        if wd.trips and "trip" not in box:
            box["trip"] = wd.last_trip
        time.sleep(0.005)
    t.join()
    if "error" in box:
        raise box["error"]
    return box.get("trip", wd.last_trip)


def _stall_scenario(p, sink):
    wd = p.watchdog.arm_watchdog(0.25, poll=0.05, sink=sink)
    try:
        def run(view):
            faults = [p.tu.FaultSpec(2, "delay", seconds=1.2)] if view.rank == 2 else []
            g = p.res.ResilientGroup(
                p.tu.FaultInjectionGroup(view, faults), timeout=20.0, policy="quorum"
            )
            for i in range(4):
                g.allgather_object({"rank": view.rank, "i": i})

        trip = _first_trip(wd, lambda: p.tu.ThreadWorld(4, timeout=30.0).run(run))
        diff = p.flight.diff_flight_rings(trip["flight"])
        return (wd.trips >= 1, trip["rank"], trip["op"], diff.ok, diff.stalled_rank,
                diff.stalled_seq, diff.stalled_op, max(diff.last_completed.values()))
    finally:
        p.watchdog.disarm_watchdog()


def test_watchdog_trip_and_flight_diff_name_the_slow_rank_like_jax():
    out = {}
    for name, p in PKGS.items():
        sink = io.StringIO()
        with _recording(p) as rec:
            verdict = _stall_scenario(p, sink)
            stalls = [e for e in rec.log.tail() if e.kind == "stall"]
        out[name] = verdict
        assert "stall watchdog" in sink.getvalue() and "IN FLIGHT" in sink.getvalue()
        assert stalls and stalls[0].op == "allgather_object" and stalls[0].rank == 2
    assert out["jax"] == out["port"]
    assert out["port"] == (True, 2, "allgather_object", False, 2, 2, "allgather_object", 3)


def _flight_records_scenario(p):
    fl = p.flight.FLIGHT
    fl.enable("test")
    try:
        def run(view):
            g = p.res.ResilientGroup(view, timeout=10.0, policy="quorum")
            g.allgather_object({"r": view.rank})
            g.allgather_array(np.full(4, view.rank, np.float32))
            return [(r.seq, r.op, r.state, r.attempts, r.payload_bytes) for r in fl._ring().tail()]

        rings = p.tu.ThreadWorld(2).run(run)
        local = p.res.ResilientGroup(p.local_group(3), timeout=10.0, policy="quorum")
        local.allgather_object([{"r": r} for r in range(3)])
        verdict = p.flight.diff_flight_rings(fl.per_rank())
        return rings, (verdict.ok, verdict.last_completed)
    finally:
        fl.disable("test")
        fl.reset()


def test_flight_records_and_verdicts_match_over_both_group_kinds():
    for p in PKGS.values():
        p.clean()
    assert _flight_records_scenario(PKGS["jax"]) == _flight_records_scenario(PKGS["port"])


def test_timeout_error_carries_flight_tail_and_retry_event():
    for p in PKGS.values():
        with _recording(p) as rec:
            g = p.res.ResilientGroup(
                p.tu.FaultInjectionGroup(p.local_group(2), [p.tu.FaultSpec(0, "delay", seconds=0.6)]),
                timeout=0.1, retries=0, policy="raise",
            )
            with pytest.raises(p.res.SyncTimeoutError) as info:
                g.allgather_object([{"r": 0}, {"r": 1}])
            assert "allgather_object" in info.value.flight_tail
            reasons = [e.reason for e in rec.log.tail() if e.kind == "retry"]
            assert reasons == ["timeout", "failed"]
            time.sleep(0.7)  # let the abandoned attempt land before the next test


# ------------------------------------------------------------- exporters


# the unported sources' families, the port's own example-buffer growth
# and CUDA-graph sources, and the count of compile events, which exists
# only once a compile event was recorded (XLA programs in one package,
# CUDA-graph captures in the other)
_UNPORTED_FAMILIES = re.compile(
    r"^torcheval_tpu_((admission|quality|buffers|graphs)_|events_kind_compile$)"
)


def _families(text):
    """{family: (type, sorted label-key sets)} of a text exposition."""
    types, labels = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            types[name] = kind
        elif line and not line.startswith("#"):
            m = re.match(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{([^}]*)\})? (\S+)$", line)
            assert m, line
            float(m.group(4))
            keys = tuple(sorted(kv.split("=")[0] for kv in (m.group(3) or "").split(",") if kv))
            base = re.sub(r"_(bucket|sum|count)$", "", m.group(1))
            labels.setdefault(base if base in types else m.group(1), set()).add(keys)
    return {
        name: (kind, sorted(labels.get(name, ())))
        for name, kind in types.items()
        if not _UNPORTED_FAMILIES.match(name)
    }


def test_prometheus_families_and_labels_match(tmp_path, monkeypatch):
    texts = {}
    for name, p in PKGS.items():
        # a fresh process-wide sync record: earlier config-driven syncs in
        # this process would add the gauges their values fill
        monkeypatch.setattr(p.res, "_DEFAULT_HEALTH", p.res.SyncHealth())
        with _recording(p, watchdog=30.0, slos=[p.monitor.SloSpec("lat", "latency/update/Mean:p99", "max", 10.0)]):
            _core_scenario(p)
            p.obs.track_metrics({"acc": p.metric("MulticlassAccuracy")}, source="memory")
            texts[name] = p.obs.render_prometheus()
            report = p.obs.format_report()
            p.obs.default_registry().unregister("memory")
        assert report.startswith("torcheval_tpu observability report")
        assert "[latency]" in report and "[events]" in report
    assert _families(texts["port"]) == _families(texts["jax"])
    assert "torcheval_tpu_latency_seconds" in _families(texts["port"])


def test_jsonl_streams_cross_read_and_chrome_trace_loads(tmp_path):
    for name, p in PKGS.items():
        path, trace = tmp_path / f"{name}.jsonl", tmp_path / f"{name}.json"
        with _recording(p, jsonl=str(path), chrome_trace=str(trace)) as rec:
            _core_scenario(p)
            recorded = [e.as_dict() for e in rec.log.tail()]
        other = PKGS["port" if name == "jax" else "jax"]
        assert [e.as_dict() for e in other.obs.read_jsonl(str(path))] == recorded
        assert len(path.read_text().splitlines()) == len(recorded)
        loaded = json.loads(trace.read_text())
        assert all({"ph", "ts", "pid", "tid"} <= set(r) for r in loaded["traceEvents"])


def test_memory_reports_match():
    reports = {}
    for name, p in PKGS.items():
        panel = {
            "acc": p.metric("MulticlassAccuracy", average="macro", num_classes=NUM_CLASSES),
            "cm": p.metric("MulticlassConfusionMatrix", NUM_CLASSES),
            "auroc": p.metric("BinaryAUROC"),
        }
        x = np.random.default_rng(0).random(32).astype(np.float32)
        panel["auroc"].update(p.arr(x), p.arr((x > 0.5).astype(np.float32)))
        with _recording(p) as rec:
            reports[name] = p.obs.memory_report(panel)
            assert [e.kind for e in rec.log.tail()] == ["memory"] * 3
    assert reports["port"] == reports["jax"]


def test_program_costs_run_on_copies_and_state_which_fields_are_none():
    p = PKGS["port"]
    m = p.metric("MulticlassAccuracy")
    x, y = _batches(5, n=1)[0]
    before = {k: v.clone() for k, v in m.state_dict().items()}
    costs = p.obs.metric_update_costs(m, p.arr(x), p.arr(y))
    assert set(costs) == {"flops", "argument_bytes", "output_bytes", "temp_bytes",
                          "peak_bytes", "generated_code_bytes"}
    assert costs["argument_bytes"] > 0 and costs["output_bytes"] > 0
    assert costs["temp_bytes"] is None and costs["peak_bytes"] is None
    assert costs["generated_code_bytes"] is None
    assert all(torch.equal(before[k], v) for k, v in m.state_dict().items())
    a = torch.ones(4, 8)
    mm = p.obs.program_costs(lambda u, v: u @ v, a, torch.ones(8, 3))
    assert mm["flops"] == 2 * 4 * 8 * 3 and mm["output_bytes"] == 4 * 3 * 4
    assert p.obs.metric_update_costs(p.metric("BinaryAUROC"), p.arr(x[:, 0]), p.arr(x[:, 1])) is None


# -------------------------------------------------------------- monitor + server


def test_toolkit_feeds_monitor_only_host_scalars():
    for p in PKGS.values():
        mon = p.monitor.arm_monitor(warmup=2)
        try:
            reps = []
            for _ in range(2):
                t = p.metric("Throughput")
                t.update(10, 0.5)
                reps.append(t)
            p.toolkit.sync_and_compute(reps, p.local_group(2))
            acc = [p.metric("MulticlassAccuracy") for _ in range(2)]
            for a in acc:
                x, y = _batches(6, n=1)[0]
                a.update(p.arr(x), p.arr(y))
            p.toolkit.sync_and_compute_collection([{"acc": a} for a in acc], p.local_group(2))
            assert sorted(mon._series) == ["computed/Throughput"]
        finally:
            p.monitor.disarm_monitor()


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items() if k not in ("alerts",)}
    return type(tree).__name__ if tree is not None else None


def test_health_server_endpoints_match_and_stop_at_scope_exit(monkeypatch):
    out = {}
    for name, p in PKGS.items():
        # a fresh process-wide sync record (see the Prometheus twin)
        monkeypatch.setattr(p.res, "_DEFAULT_HEALTH", p.res.SyncHealth())
        with _recording(p, serve=0, watchdog=30.0, slos=[]):
            srv = p.obs.current_server()
            _core_scenario(p)
            status, body = _get(srv.url + "/healthz")
            health = json.loads(body)
            mstatus, metrics = _get(srv.url + "/metrics")
            fstatus, flight = _get(srv.url + "/flight")
            rstatus, report = _get(srv.url + "/report")
            nstatus, _ = _get(srv.url + "/nope")
            url = srv.url
        assert (status, mstatus, fstatus, rstatus, nstatus) == (200, 200, 200, 200, 404)
        assert health["status"] == "ok" and health["healthy"]
        json.loads(flight)
        assert report.startswith("torcheval_tpu observability report")
        assert p.obs.current_server() is None
        with pytest.raises((urllib.error.URLError, ConnectionError, OSError)):
            urllib.request.urlopen(url + "/healthz", timeout=2)
        counts = {line.split()[0]: float(line.split()[1]) for line in metrics.splitlines()
                  if line.startswith("torcheval_tpu_latency_seconds_count")}
        out[name] = (_keys(health), {k: v for k, v in counts.items()})
    assert out["port"][0] == out["jax"][0]
    assert out["port"][1] == out["jax"][1]
    assert PKGS["port"].obs.healthz_payload()["federation"] == {"armed": 0}


def test_healthz_turns_503_on_a_tripped_watchdog_and_an_active_alert():
    for p in PKGS.values():
        with _recording(p, serve=0):
            srv = p.obs.current_server()
            wd = p.watchdog.arm_watchdog(30.0, sink=None)
            wd.tripped = True
            status, body = _get(srv.url + "/healthz")
            assert status == 503 and json.loads(body)["status"] == "stalled"
            wd.tripped = False
            p.watchdog.disarm_watchdog()
            mon = p.monitor.arm_monitor(slos=(p.monitor.SloSpec("x", "events.recorded_total", "max", -1.0),))
            status, body = _get(srv.url + "/healthz")
            assert status == 503 and json.loads(body)["status"] == "alerting"
            p.monitor.disarm_monitor()
            assert mon.alerts_total >= 1


# ------------------------------------------- captures as compile events (emulated)


def test_ragged_bucketed_stream_stays_within_bucket_bound(emulated_graphs):
    from torcheval_tpu_torch.metrics._bucket import bucket_bound, bucket_length
    from torcheval_tpu_torch.utils import CompileCounter

    p = PKGS["port"]
    sizes = [64, 64, 60, 37, 32, 17, 7, 3, 64, 33]
    rng = np.random.default_rng(7)
    panel = {"acc": p.metric("MulticlassAccuracy"), "cm": p.metric("MulticlassConfusionMatrix", NUM_CLASSES)}
    single = p.metric("MulticlassAccuracy", average="macro", num_classes=NUM_CLASSES)
    with _recording(p) as rec, CompileCounter() as cc, p.config.shape_bucketing():
        for n in sizes:
            x = rng.random((n, NUM_CLASSES), np.float32)
            y = rng.integers(0, NUM_CLASSES, n)
            p.toolkit.update_collection(panel, p.arr(x), p.arr(y))
            single.update(p.arr(x), p.arr(y))
        compiles = [e for e in rec.log.tail() if e.kind == "compile"]
        with CompileCounter() as warm:
            for n in sizes:
                x = rng.random((n, NUM_CLASSES), np.float32)
                p.toolkit.update_collection(panel, p.arr(x), p.arr(rng.integers(0, NUM_CLASSES, n)))
    buckets = {bucket_length(n) for n in sizes}
    assert cc.programs == emulated_graphs.graph_stats()["captures"] == 2 * len(buckets)
    assert len(buckets) <= bucket_bound(max(sizes))
    assert cc.compiles == cc.programs and cc.cache_hits == 0 and cc.compile_secs > 0
    assert warm.programs == 0
    assert len(compiles) == cc.programs and not any(e.cache_hit for e in compiles)
    panel_sites = [e for e in compiles if e.site == "torcheval.update_collection"]
    single_sites = [e for e in compiles if e.site == "torcheval.update/MulticlassAccuracy"]
    assert len(panel_sites) == len(single_sites) == len(buckets)
    assert sorted(e.bucket for e in panel_sites) == sorted(buckets)
    assert sorted(e.bucket for e in single_sites) == sorted(buckets)
    reg = p.obs.default_registry().read()["compile"]
    assert set(reg) == {"programs", "compiles", "cache_hits", "compile_secs"}
