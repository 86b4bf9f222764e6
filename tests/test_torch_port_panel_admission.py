"""``TablePanel`` and the admission ladder of the port against the JAX
package's, on the CPU: per-alias panel values and states, member
validation, the keep verdicts and Horvitz-Thompson weights (bitwise: host
numpy in both packages), an armed table walked through a seeded spike
(rung trajectory, states and values equal to the JAX package's, bitwise:
integer clicks times the same ``1/p`` weights, added in the same order),
provenance, and the observability surface (``/healthz`` shedding, the
``admission`` counter source, ``AdmissionEvent``)."""

from __future__ import annotations

import numpy as np
import pytest

from torcheval_tpu.metrics import ShardContext as JShard
from torcheval_tpu.metrics.toolkit import adopt_synced as j_adopt
from torcheval_tpu.table import AdmissionController as JController
from torcheval_tpu.table import MetricTable as JTable
from torcheval_tpu.table import ServingBudget as JBudget
from torcheval_tpu.table import TablePanel as JPanel
from torcheval_tpu.table import admission_keep as j_admission_keep
from torcheval_tpu.utils.test_utils import OverloadSchedule as JSchedule
from torcheval_tpu_torch import obs
from torcheval_tpu_torch.metrics import ShardContext
from torcheval_tpu_torch.metrics.toolkit import adopt_synced
from torcheval_tpu_torch.obs.counters import _admission_source
from torcheval_tpu_torch.obs.server import healthz_payload
from torcheval_tpu_torch.table import (
    AdmissionController,
    AdmissionProvenance,
    MetricTable,
    ServingBudget,
    TablePanel,
    admission_keep,
    hash_keys,
    shedding_status,
)
from torcheval_tpu_torch.utils.convert import load_numpy_state_dict, numpy_state_dict
from torcheval_tpu_torch.utils.test_utils import OverloadSchedule
from tests.test_torch_port_table import NE_RTOL, assert_same_state, assert_same_values, jax_sd

CPU = "cpu"
MEMBERS = ["ctr", ("cal", "weighted_calibration"), "ne", ("wne", "windowed_ne", {"window": 3})]
# the NE members' cross-entropy columns (and the outbox rows carrying them)
NE_LOGS = ("col_ne__total_entropy", "col_wne__total_entropy", "ring_wne__total_entropy", "out_val")


def _bundle(rng, n):
    clicks = rng.integers(0, 2, n).astype(np.float32)
    preds = (rng.integers(1, 8, n) / 8).astype(np.float32)
    return dict(ctr=(clicks,), cal=(preds, clicks), ne=(preds, clicks), wne=(preds, clicks))


# ------------------------------------------------------------------ panel


@pytest.mark.parametrize("world", [1, 2])
def test_panel_values_and_states_equal_jax(world):
    rng = np.random.default_rng(1)
    for rank in range(world):
        pt = TablePanel(MEMBERS, shard=ShardContext(rank, world), device=CPU)
        jt = JPanel(MEMBERS, shard=JShard(rank, world))
        for n in (40, 13, 64):
            keys = rng.integers(0, 50, n)
            b = _bundle(np.random.default_rng(n), n)
            pt.ingest(keys, **b)
            jt.ingest(keys, **b)
        if world == 1:
            adopt_synced(pt)
            j_adopt(jt)
        got, want = pt.compute(), jt.compute()
        np.testing.assert_array_equal(got.keys, want.keys)
        assert pt.aliases == ("ctr", "cal", "ne", "wne")
        for alias in pt.aliases:
            g, w = got.values[alias].numpy(), np.asarray(want.values[alias])
            if alias in ("ne", "wne"):
                np.testing.assert_allclose(g, w, rtol=NE_RTOL, atol=0)
            else:
                assert g.tobytes() == w.tobytes(), alias
        assert_same_state(pt, jt, NE_LOGS)
        assert pt.scrape_values(limit=4).keys() == jt.scrape_values(limit=4).keys()


def test_panel_member_and_bundle_validation():
    with pytest.raises(ValueError, match="duplicate"):
        TablePanel(["ctr", "ctr"], device=CPU)
    with pytest.raises(ValueError, match="window"):
        TablePanel([("a", "windowed_ne", {"window": 2}), ("b", "windowed_ne", {"window": 3})], device=CPU)
    with pytest.raises(ValueError, match="alias"):
        TablePanel([("bad-alias", "ctr")], device=CPU)
    with pytest.raises(ValueError, match="at least one"):
        TablePanel([], device=CPU)
    p = TablePanel(["ctr", "ne"], device=CPU)
    with pytest.raises(TypeError, match="missing"):
        p.ingest([1], ctr=([1.0],))
    with pytest.raises(TypeError, match="keyword"):
        p.ingest([1], [1.0])
    # dict bundles and the member view's attributes
    p.ingest([1, 2], ctr={"clicks": [1.0, 0.0]}, ne={"preds": [0.5, 0.25], "targets": [1.0, 0.0]})
    assert set(p.compute().as_dict()) == {"ctr", "ne"}


def test_panel_state_cross_loads_both_ways():
    rng = np.random.default_rng(2)
    keys = rng.integers(0, 30, 40)
    b = _bundle(rng, 40)
    jt = JPanel(MEMBERS)
    jt.ingest(keys, **b)
    pt = TablePanel(MEMBERS, device=CPU)
    load_numpy_state_dict(pt, jax_sd(jt))
    assert_same_state(pt, jt, NE_LOGS)
    back = JPanel(MEMBERS)
    back.load_state_dict(numpy_state_dict(pt))
    assert_same_state(pt, back, NE_LOGS)


# -------------------------------------------------------------- admission


def test_keep_verdicts_and_ht_weights_equal_jax_bitwise():
    rng = np.random.default_rng(3)
    hashed = hash_keys(rng.integers(0, 1 << 40, 20000))
    for epoch in (0, 1, 7, 2**40):
        for p in (1.0, 0.5, 0.1, 0.01, 0.0):
            np.testing.assert_array_equal(admission_keep(hashed, epoch, p), j_admission_keep(hashed, epoch, p))
    prio = rng.integers(0, 1 << 40, 50)
    port = AdmissionController(ServingBudget(max_keys=100), priority_keys=prio)
    jax_c = JController(JBudget(max_keys=100), priority_keys=prio)
    for rung in (0, 1, 2):
        for (k1, w1), (k2, w2) in [(port.decide(hashed, 3, rung), jax_c.decide(hashed, 3, rung))]:
            np.testing.assert_array_equal(k1, k2)
            assert w1[k1].tobytes() == w2[k2].tobytes()


def test_controller_validation_and_rescale():
    with pytest.raises(ValueError, match="sample_p"):
        AdmissionController(ServingBudget(), sample_p=0.0)
    with pytest.raises(ValueError, match="floor_p"):
        AdmissionController(ServingBudget(), sample_p=0.1, floor_p=0.5)
    with pytest.raises(ValueError, match="exit_pressure"):
        AdmissionController(ServingBudget(), enter_pressure=0.5, exit_pressure=0.9)
    with pytest.raises(TypeError, match="AdmissionController"):
        MetricTable("ctr", device=CPU).arm_admission(object())
    c = AdmissionController(ServingBudget(max_outbox=300))
    c.rescale_world(4, 2)
    j = JController(JBudget(max_outbox=300))
    j.rescale_world(4, 2)
    assert c.budget.max_outbox == j.budget.max_outbox
    t = MetricTable("ctr", max_keys=50, device=CPU, admission=AdmissionController(ServingBudget(max_keys=20)))
    assert t.max_keys == 20


def _ladder_tables(reservoir=0):
    kw = dict(sample_p=0.3, cooldown_drains=2, check_every=1, priority_reservoir=reservoir)
    pt = MetricTable("ctr", device=CPU, admission=AdmissionController(ServingBudget(max_keys=32), **kw))
    jt = JTable("ctr", admission=JController(JBudget(max_keys=32), **kw))
    return pt, jt


@pytest.mark.parametrize("reservoir", [0, 4])
def test_ladder_walk_under_a_seeded_spike_equals_jax(reservoir):
    pt, jt = _ladder_tables(reservoir)
    spikes = (
        (OverloadSchedule.ramp(6, 12.0, cardinality=12.0, base_rows=48, base_keys=24, seed=9),
         JSchedule.ramp(6, 12.0, cardinality=12.0, base_rows=48, base_keys=24, seed=9)),
        (OverloadSchedule.sustained(8, 1.0, base_rows=8, base_keys=8, seed=10),
         JSchedule.sustained(8, 1.0, base_rows=8, base_keys=8, seed=10)),
    )
    trajectory = []
    try:
        for ps, js in spikes:
            for pb, jb in zip(ps.batches(), js.batches()):
                np.testing.assert_array_equal(pb.keys, jb.keys)
                pt.ingest(pb.keys, **pb.kwargs)
                jt.ingest(jb.keys, **jb.kwargs)
                adopt_synced(pt)
                j_adopt(jt)
                assert int(pt.admission_rung) == int(jt.admission_rung)
                assert_same_state(pt, jt)
                trajectory.append(int(pt.admission_rung))
                assert pt.sync_provenance.admission_rung == int(pt.admission_rung)
        assert max(trajectory) >= 1 and trajectory[-1] == 0
        np.testing.assert_array_equal(pt._admission._priority_hashes, jt._admission._priority_hashes)
        assert_same_values(pt.compute(), jt.compute())
        assert pt.admission_provenance == AdmissionProvenance(*jt.admission_provenance)
    finally:
        pt.disarm_admission()
        jt.disarm_admission()


def test_admitted_keys_read_their_full_ingest_values():
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 400, 4000)
    clicks = rng.integers(0, 2, 4000).astype(np.float32)
    armed = MetricTable("ctr", device=CPU, admission=AdmissionController(ServingBudget(max_keys=10**6)))
    try:
        armed.admission_rung = 1
        armed.ingest(keys, clicks)
        full = MetricTable("ctr", device=CPU)
        full.ingest(keys, clicks)
        got, want = armed.compute().as_dict(), full.compute().as_dict()
        assert 0 < len(got) < len(want)
        for k, v in got.items():
            assert v == want[k], k
        assert int(armed.shed_rows_total) > 0
    finally:
        armed.disarm_admission()


def test_observability_surface_reports_the_shedding_rung():
    t = MetricTable("ctr", device=CPU, admission=AdmissionController(ServingBudget(max_keys=8)))
    try:
        t.admission_rung = 1
        status = shedding_status()
        assert status["shedding"] and status["rung_name"] == "sampled" and status["armed"] >= 1
        payload = healthz_payload()
        assert payload["status"] == "shedding" and payload["healthy"]
        assert payload["admission"]["rung_name"] == "sampled"
        src = _admission_source()
        assert src["armed"] >= 1 and src["rung"] == 1 and src["sampled_fraction"] == 0.1
        t.admission_rung = 0
        assert healthz_payload()["status"] == "ok"
    finally:
        t.disarm_admission()
    assert healthz_payload()["admission"]["armed"] == 0
    assert _admission_source()["armed"] == 0


def test_admission_event_recorded_on_a_transition():
    rec = obs.recorder()
    t = MetricTable("ctr", device=CPU,
                    admission=AdmissionController(ServingBudget(max_keys=4), check_every=1))
    try:
        rec.enable()
        before = rec.log.total
        t.ingest(np.arange(40), np.ones(40, np.float32))
        adopt_synced(t)
        new = rec.log.tail(rec.log.total - before)
        events = [e for e in new if e.kind == "admission"]
        assert len(events) == 1 and events[0].rung == 1 and events[0].prev_rung == 0
    finally:
        rec.disable()
        t.disarm_admission()


def test_provenance_dropped_on_reset_and_load():
    t = MetricTable("ctr", device=CPU, admission=AdmissionController(ServingBudget(max_keys=8)))
    try:
        t.ingest([1, 2], [1.0, 0.0])
        t.compute()
        assert isinstance(t.admission_provenance, AdmissionProvenance)
        t.load_state_dict(t.state_dict())
        assert not hasattr(t, "admission_provenance")
        t.compute()
        t.reset()
        assert not hasattr(t, "admission_provenance")
    finally:
        t.disarm_admission()
