"""``watch_inputs`` and drift scoring in the port
(``torcheval_tpu_torch/obs/quality.py``) against the JAX package's
``torcheval_tpu/obs/quality.py``, twins of ``tests/metrics/test_quality.py``.

Each twin feeds the same seeded numpy inputs to both packages on the CPU.
The watched states' counter, histogram and register lanes are held
bitwise to the JAX package's watched metric and to a standalone sketch;
the moments to ``MOMENT_RTOL`` against the JAX package (its batch sums are
sequential, torch's are not) and bitwise inside the port; PSI, KS and
Welch z to ``SCORE_RTOL`` (they are float64 host math over those states).
"""

from __future__ import annotations

import copy
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as JM
from torcheval_tpu import obs as jobs
from torcheval_tpu.obs import quality as JQ
import torcheval_tpu_torch.metrics as TM
from torcheval_tpu_torch import config, obs
from torcheval_tpu_torch.distributed import LocalReplicaGroup
from torcheval_tpu_torch.metrics import toolkit
from torcheval_tpu_torch.obs import quality
from torcheval_tpu_torch.utils import CompileCounter, load_numpy_state_dict, numpy_state_dict
from torcheval_tpu_torch.utils.test_utils import ThreadWorld

CPU = "cpu"
MOMENT_RTOL = 1e-5
# drift scores are float64 host math over the sketch states; the window
# moments carry the moments' float32 sum-order difference
SCORE_RTOL = 1e-4
STATE_NAMES = ("hist", "counts", "moments", "registers")
Q_STATES = ("_q0_hist", "_q0_cnt", "_q0_mom", "_q0_reg")

RNG = np.random.default_rng(13)
X2 = RNG.random((32, 5)).astype(np.float32)
T1 = RNG.integers(0, 5, 32)


@pytest.fixture(autouse=True)
def _clean_quality():
    """No watch (or paused gate) leaks across tests, in either package."""
    yield
    for q in (quality, JQ):
        for watch in q.active_watches():
            watch.close()
        q.QUALITY.enabled = True


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _hex(metric, name):
    v = getattr(metric, name)
    return (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)).tobytes().hex()


def _oracle_sketch(stream, **kw):
    kw.setdefault("bounds", (0.0, 1.0))
    kw.setdefault("num_bins", 8)
    sk = obs.InputSketch(device=CPU, **kw)
    for x in stream:
        sk.update(_t(x))
    return sk


def test_watch_fuses_bit_identical_to_standalone_sketch_and_jax():
    metric = TM.MulticlassAccuracy(device=CPU)
    watch = quality.watch_inputs(metric, bounds=(0.0, 1.0), num_bins=8)
    jmetric = JM.MulticlassAccuracy()
    jwatch = JQ.watch_inputs(jmetric, bounds=(0.0, 1.0), num_bins=8)
    assert watch.series == jwatch.series == ("MulticlassAccuracy/0",)
    for _ in range(2):
        metric.update(_t(X2), _t(T1))
        jmetric.update(jnp.asarray(X2), jnp.asarray(T1))
    snap = watch.sketch("MulticlassAccuracy/0")
    oracle = _oracle_sketch([X2, X2])
    for name in STATE_NAMES:
        assert _hex(snap, name) == _hex(oracle, name), name
    for ours, theirs in zip(Q_STATES, Q_STATES):
        if ours != "_q0_mom":
            assert _hex(metric, ours) == _hex(jmetric, theirs), ours
    np.testing.assert_allclose(metric._q0_mom.numpy(), np.asarray(jmetric._q0_mom),
                               rtol=MOMENT_RTOL)
    bare = TM.MulticlassAccuracy(device=CPU)
    for _ in range(2):
        bare.update(_t(X2), _t(T1))
    assert _hex(metric, "num_correct") == _hex(bare, "num_correct")


def test_watch_update_collection_panel_path():
    coll = {"acc": TM.MulticlassAccuracy(device=CPU), "f1": TM.MulticlassF1Score(device=CPU)}
    watch = quality.watch_inputs(coll, bounds=(0.0, 1.0), num_bins=8)
    assert watch.series == ("acc/0", "f1/0")
    toolkit.update_collection(coll, _t(X2), _t(T1))
    oracle = _oracle_sketch([X2])
    for name in ("acc", "f1"):
        snap = watch.sketch(f"{name}/0")
        for state in STATE_NAMES:
            assert _hex(snap, state) == _hex(oracle, state), (name, state)


def test_watch_off_gate_is_baseline_plan():
    metric = TM.MulticlassAccuracy(device=CPU)
    baseline = metric._update_plan(_t(X2), _t(T1))
    quality.watch_inputs(metric)
    quality.QUALITY.enabled = False
    paused = metric._update_plan(_t(X2), _t(T1))
    assert paused[0] is baseline[0] and paused[1] == baseline[1]
    metric.update(_t(X2), _t(T1))
    assert float(metric._q0_mom[0]) == 0.0
    quality.QUALITY.enabled = True
    metric.update(_t(X2), _t(T1))
    assert float(metric._q0_mom[0]) == 160.0


def test_watch_contracts():
    with pytest.raises(TypeError, match="fusable update plan"):
        quality.watch_inputs(TM.BinaryAUROC(device=CPU))
    metric = TM.Mean(device=CPU)
    quality.watch_inputs(metric, label="a")
    with pytest.raises(ValueError, match="already quality-watched"):
        quality.watch_inputs(metric)
    with pytest.raises(ValueError, match="empty collection"):
        quality.watch_inputs({})
    with pytest.raises(ValueError, match="non-negative"):
        quality.watch_inputs(TM.Sum(device=CPU), args=(-1,))
    extra = TM.Mean(device=CPU)
    quality.watch_inputs(extra, args=(0, 2), label="b")
    with pytest.raises(ValueError, match="out of range"):
        extra.update(torch.zeros(8))


def test_watch_collection_validation_is_all_or_nothing():
    mean = TM.Mean(device=CPU)
    with pytest.raises(TypeError, match="fusable update plan"):
        quality.watch_inputs({"mean": mean, "auroc": TM.BinaryAUROC(device=CPU)})
    assert getattr(mean, "_quality_spec", None) is None
    assert "_q0_cnt" not in mean._state_name_to_default
    quality.watch_inputs(mean)


def test_watch_series_names_must_be_unique_across_watches():
    quality.watch_inputs(TM.Mean(device=CPU))
    with pytest.raises(ValueError, match="already exist on an active"):
        quality.watch_inputs(TM.Mean(device=CPU))
    quality.watch_inputs(TM.Mean(device=CPU), label="other")


def test_watch_bucketing_zero_fresh_captures_and_parity():
    """A warmed watched metric under shape bucketing: fresh ragged sizes
    in warmed buckets make no new capture, and the integer lanes equal the
    unbucketed oracle bitwise."""
    rng = np.random.default_rng(3)
    with config.shape_bucketing():
        metric = TM.MulticlassAccuracy(device=CPU)
        quality.watch_inputs(metric, bounds=(0.0, 1.0), num_bins=8)
        sizes_warm, sizes_fresh = (8, 16, 32, 64), (5, 9, 27, 50, 61)
        batches = [(rng.random((n, 5)).astype(np.float32), rng.integers(0, 5, n))
                   for n in sizes_warm + sizes_fresh]
        for x, t in batches[: len(sizes_warm)]:
            metric.update(_t(x), _t(t))
        with CompileCounter() as cc:
            for x, t in batches[len(sizes_warm):]:
                metric.update(_t(x), _t(t))
        assert cc.programs == 0
    oracle = _oracle_sketch([x for x, _ in batches])
    assert _hex(metric, "_q0_hist") == _hex(oracle, "hist")
    assert _hex(metric, "_q0_cnt") == _hex(oracle, "counts")
    assert _hex(metric, "_q0_reg") == _hex(oracle, "registers")
    np.testing.assert_allclose(metric._q0_mom.numpy(), oracle.moments.numpy(), rtol=2e-5)


def test_watch_multiple_args():
    metric = TM.MeanSquaredError(device=CPU)
    xb = RNG.random(64).astype(np.float32)
    tb = RNG.random(64).astype(np.float32)
    watch = quality.watch_inputs(metric, args=(0, 1), bounds=(0.0, 1.0), num_bins=8)
    metric.update(_t(xb), _t(tb))
    assert watch.series == ("MeanSquaredError/0", "MeanSquaredError/1")
    for series, stream in (("MeanSquaredError/0", [xb]), ("MeanSquaredError/1", [tb])):
        snap = watch.sketch(series)
        oracle = _oracle_sketch(stream)
        for name in STATE_NAMES:
            assert _hex(snap, name) == _hex(oracle, name), (series, name)


def test_watched_sync_rides_the_payload():
    metric = TM.Mean(device=CPU)
    quality.watch_inputs(metric, bounds=(0.0, 1.0), num_bins=8)
    metric.update(_t(RNG.random(32).astype(np.float32)))
    twin = copy.deepcopy(metric)
    synced = toolkit.get_synced_metric([metric, twin], LocalReplicaGroup([CPU, CPU]))
    # two identical replicas: SUM states double, MAX registers stay,
    # moments Chan-merge (the count doubles)
    assert float(synced._q0_cnt[0]) == 64.0 and float(synced._q0_mom[0]) == 64.0
    assert _hex(synced, "_q0_reg") == _hex(metric, "_q0_reg")
    assert float(synced._q0_mom[1]) == pytest.approx(float(metric._q0_mom[1]), rel=1e-6)


def test_watched_sharded_metric_merges_sketch_states():
    """``_custom_mergeable_states``: a watched SHARDED metric's moments
    merge in the reassembling merge, not kept at self's value."""
    batches = [(RNG.integers(0, 8, 32), RNG.integers(0, 8, 32)) for _ in range(2)]

    def body(g):
        metric = TM.MulticlassConfusionMatrix(8, device=CPU, shard=TM.ShardContext(g.rank, 2))
        quality.watch_inputs(metric, bounds=(0.0, 8.0), num_bins=8, label=f"cm{g.rank}")
        t, p = batches[g.rank]
        metric.update(_t(t), _t(p))
        synced = toolkit.get_synced_metric(metric, g)
        return float(synced._q0_mom[0]), _hex(synced, "_q0_cnt"), int(synced.confusion_matrix.sum())

    oracle = _oracle_sketch([t.astype(np.float32) for t, _ in batches], bounds=(0.0, 8.0))
    for count, cnt_hex, total in ThreadWorld(2).run(body):
        assert count == 64.0 and cnt_hex == _hex(oracle, "counts") and total == 64


def test_watched_donation_in_place():
    with config.update_donation(True):
        metric = TM.MulticlassAccuracy(device=CPU)
        quality.watch_inputs(metric, bounds=(0.0, 1.0), num_bins=8)
        for _ in range(3):
            metric.update(_t(X2), _t(T1))
        ptr = metric._q0_hist.data_ptr()
        metric.update(_t(X2), _t(T1))
        assert metric._q0_hist.data_ptr() == ptr
        assert int(metric._q0_cnt[0]) == 4 * 160
        metric.reset()
        assert int(metric._q0_cnt[0]) == 0


def test_watched_state_dict_cross_loads_both_ways():
    metric = TM.Mean(device=CPU)
    quality.watch_inputs(metric, bounds=(-4.0, 4.0), num_bins=16, label="t")
    jmetric = JM.Mean()
    JQ.watch_inputs(jmetric, bounds=(-4.0, 4.0), num_bins=16, label="j")
    x = RNG.normal(size=128).astype(np.float32)
    jmetric.update(jnp.asarray(x))
    load_numpy_state_dict(metric, {k: np.asarray(v) for k, v in jmetric.state_dict().items()})
    for name in Q_STATES:
        assert _hex(metric, name) == _hex(jmetric, name), name
    back = JM.Mean()
    JQ.watch_inputs(back, bounds=(-4.0, 4.0), num_bins=16, label="back")
    back.load_state_dict({k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                          for k, v in numpy_state_dict(metric).items()})
    for name in Q_STATES:
        assert _hex(back, name) == _hex(metric, name), name


# ------------------------------------------------------------------- drift


def _drift_stream(shift):
    rng = np.random.default_rng(11)
    ref = [rng.normal(size=512).astype(np.float32) for _ in range(4)]
    live = [(rng.normal(size=512) + shift).astype(np.float32) for _ in range(4)]
    return ref, live


def _drifted_watch(shift=1.5, cooldown=0.0, pkg="torch"):
    ref, live = _drift_stream(shift)
    if pkg == "torch":
        q, Mean, to, Monitor = quality, lambda: TM.Mean(device=CPU), _t, obs.Monitor
    else:
        q, Mean, to, Monitor = JQ, JM.Mean, jnp.asarray, jobs.Monitor
    metric = Mean()
    watch = q.watch_inputs(metric, bounds=(-4.0, 4.0), num_bins=16, label=f"score{pkg[0]}")
    for x in ref:
        metric.update(to(x))
    watch.add_drift(q.DriftSpec(psi=0.2, ks=0.15, z=6.0, min_count=128))
    monitor = Monitor(cooldown=cooldown)
    assert monitor.check() == []
    for x in live:
        metric.update(to(x))
    return metric, watch, monitor


@pytest.mark.parametrize("shift", [0.0, 0.3, 1.5])
def test_drift_scores_match_jax(shift):
    _, watch, _ = _drifted_watch(shift)
    _, jwatch, _ = _drifted_watch(shift, pkg="jax")
    ours, theirs = watch.score("scoret/0"), jwatch.score("scorej/0")
    assert ours["count"] == theirs["count"] == 2048.0
    assert ours["ref_count"] == theirs["ref_count"] == 2048.0
    for key in ("psi", "ks", "z"):
        assert math.isclose(ours[key], theirs[key], rel_tol=SCORE_RTOL, abs_tol=1e-6), key


def test_moments_window_and_hll_estimate_match_jax():
    from torcheval_tpu.obs import sketch as JS
    from torcheval_tpu_torch.obs import sketch as TS

    live = np.array([1000.0, 0.4, 950.0, -3.0, 4.0], np.float32)
    ref = np.array([400.0, 0.1, 380.0, -2.5, 3.5], np.float32)
    np.testing.assert_array_equal(TS.moments_window(live, ref), JS.moments_window(live, ref))
    np.testing.assert_array_equal(TS.moments_window(ref, ref), JS.moments_window(ref, ref))
    regs = np.random.default_rng(4).integers(0, 12, 64).astype(np.int32)
    assert TS.hll_estimate(regs) == JS.hll_estimate(regs)
    assert TS.hll_estimate(np.zeros(64, np.int32)) == JS.hll_estimate(np.zeros(64, np.int32))


def test_drift_scores_and_alerts():
    metric, watch, monitor = _drifted_watch()
    raised = monitor.check()
    kinds = {(r["name"], r["alert"]) for r in raised}
    assert kinds == {("quality/scoret/0", "drift-psi"), ("quality/scoret/0", "drift-ks"),
                     ("quality/scoret/0", "drift-z")}
    scores = watch.score("scoret/0")
    assert scores["psi"] > 0.2 and scores["ks"] > 0.15 and scores["z"] > 6
    active = {(a["name"], a["alert"]) for a in monitor.active_alerts()}
    assert kinds <= active


def test_standing_alerts_clear_after_rebaseline_below_min_count():
    metric, watch, monitor = _drifted_watch()
    assert monitor.check()
    metric.reset()
    watch.freeze_reference()
    monitor.check()
    assert [a for a in monitor.active_alerts() if a["name"].startswith("quality/")] == []


def test_drift_degrades_healthz():
    from torcheval_tpu_torch.obs.monitor import arm_monitor, disarm_monitor
    from torcheval_tpu_torch.obs.server import healthz_payload

    _drifted_watch()
    arm_monitor(cooldown=0.0)
    try:
        payload = healthz_payload()
        assert payload["status"] == "alerting" and payload["healthy"] is False
        assert any(a["name"] == "quality/scoret/0" for a in payload["alerts"])
    finally:
        disarm_monitor()


def test_drift_event_recorded_and_roundtrips():
    from torcheval_tpu_torch.obs.events import DriftEvent, event_from_dict

    _, watch, monitor = _drifted_watch()
    rec = obs.recorder()
    rec.reset()
    with config.observability():
        monitor.check()
        events = [e for e in rec.log.tail() if e.kind == "drift"]
    assert events
    ev = events[-1]
    assert ev.series == "scoret/0" and set(ev.breach.split(",")) == {"psi", "ks", "z"}
    d = ev.as_dict()
    assert event_from_dict(d) == ev
    d["future_field"] = "x"
    assert isinstance(event_from_dict(d), DriftEvent)


def test_drift_cooldown_suppresses_repeat_alerts():
    _, _, monitor = _drifted_watch(cooldown=600.0)
    assert monitor.check()
    again = monitor.check()
    assert [r for r in again if r["name"].startswith("quality/")] == []
    assert monitor.active_alerts()


def test_drift_min_count_gate_and_unknown_series():
    rng = np.random.default_rng(2)
    metric = TM.Mean(device=CPU)
    watch = quality.watch_inputs(metric, bounds=(-4, 4), label="s")
    metric.update(_t(rng.normal(size=64).astype(np.float32)))
    watch.add_drift(quality.DriftSpec(min_count=10_000))
    metric.update(_t((rng.normal(size=64) + 5).astype(np.float32)))
    assert obs.Monitor(cooldown=0.0).check() == []
    with pytest.raises(KeyError, match="not watched"):
        watch.add_drift(quality.DriftSpec(series="nope/9"))


def test_refreeze_rebaselines():
    metric, watch, monitor = _drifted_watch()
    assert monitor.check()
    rng = np.random.default_rng(12)
    metric.reset()
    metric.update(_t((rng.normal(size=512) + 1.5).astype(np.float32)))
    watch.freeze_reference()
    metric.update(_t((rng.normal(size=512) + 1.5).astype(np.float32)))
    raised = [r for r in obs.Monitor(cooldown=0.0).check() if r["name"].startswith("quality/")]
    assert raised == []


# --------------------------------------------------------------- exporters

_PROM_LINE = re.compile(
    r"^(?:# (?:TYPE|HELP) [a-zA-Z_][a-zA-Z0-9_]* \w+$"
    r"|[a-zA-Z_][a-zA-Z0-9_]*"
    r"(?:\{[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\\n]|\\\\|\\\"|\\n)*\""
    r"(?:,[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\\n]|\\\\|\\\"|\\n)*\")*\})?"
    r" [0-9.eE+-]+(?:$|\s))"
)


def test_prometheus_quality_section_grammar_with_hostile_label():
    metric = TM.Mean(device=CPU)
    quality.watch_inputs(metric, bounds=(0.0, 1.0), num_bins=4, label='sc"o\\re\nx')
    metric.update(_t(RNG.random(64).astype(np.float32)))
    text = obs.render_prometheus()
    for line in text.splitlines():
        assert _PROM_LINE.match(line), f"unparseable line: {line!r}"
    assert 'input="sc\\"o\\\\re\\nx/0"' in text


def test_prometheus_quality_histogram_cumulative_matches_jax():
    x = np.array([0.1, 0.3, 0.6, 0.9, -1.0, 2.0], np.float32)
    texts = []
    for q, Mean, to, o in ((quality, lambda: TM.Mean(device=CPU), _t, obs),
                           (JQ, JM.Mean, jnp.asarray, jobs)):
        metric = Mean()
        q.watch_inputs(metric, bounds=(0.0, 1.0), num_bins=4, label="u")
        metric.update(to(x))
        text = o.render_prometheus()
        texts.append([l for l in text.splitlines() if "quality_value" in l])
        q.active_watches()[0].close()
    buckets = re.findall(r'torcheval_tpu_quality_value_bucket\{input="u/0",le="([^"]+)"\} (\d+)',
                         "\n".join(texts[0]))
    assert [b[0] for b in buckets] == ["0.25", "0.5", "0.75", "1", "+Inf"]
    assert [int(b[1]) for b in buckets] == [2, 3, 4, 5, 6]
    assert texts[0] == texts[1]


def test_format_report_quality_section():
    metric = TM.Mean(device=CPU)
    watch = quality.watch_inputs(metric, bounds=(-4.0, 4.0), num_bins=8, label="score")
    metric.update(_t(RNG.normal(size=256).astype(np.float32)))
    watch.add_drift(quality.DriftSpec(min_count=1))
    obs.Monitor(cooldown=0.0).check()
    report = obs.format_report()
    assert "[quality]" in report
    line = next(l for l in report.splitlines() if l.strip().startswith("score/0  "))
    assert "n=256" in line and "distinct~" in line
    assert any("drift: psi=" in l for l in report.splitlines())


def test_quality_counter_source_lifecycle():
    registry = obs.default_registry()
    assert "quality" not in registry.sources
    metric = TM.Mean(device=CPU)
    watch = quality.watch_inputs(metric, bounds=(0.0, 1.0), label="a")
    assert "quality" in registry.sources
    metric.update(_t(RNG.random(16).astype(np.float32)))
    flat = registry.flat()
    assert flat["quality.a/0_count"] == 16.0 and flat["quality.watched_inputs"] == 1
    watch.close()
    assert "quality" not in registry.sources


def test_quality_names_import_from_obs():
    for name in ("QUALITY", "DriftSpec", "QualityWatch", "active_watches", "watch_inputs",
                 "InputSketch", "SketchConfig", "SketchSummary", "chan_merge", "hll_estimate"):
        assert getattr(obs, name) is not None and name in obs.__all__
    with pytest.raises(AttributeError):
        obs.no_such_name
