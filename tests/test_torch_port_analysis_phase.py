"""``chip_smoke.py``'s ``analysis`` phase (phase 21) at a small size on the
CPU: the CLI over the package, static against runtime over every fused
family (donation on, as on the card), both seeded faults caught both
ways, K1's plain version through the verifier (no op and no launch on the
CPU; one op an update on fake CUDA tensors is pinned in
``test_torch_port_analysis_program.py``), and the lockstep plans of the
phase 4 collection, ring attention and MoE against a real ``ThreadWorld``
census. The card-only parts (the sync debug mode, K1's launches, the card
line) are checked on the card."""

from __future__ import annotations

import chip_smoke

RING = dict(sp=4, tokens=64, heads=2, head_dim=8)
MOE = dict(d_model=16, d_ff=32, experts=4, tokens=32, factor=1.25)


def test_phase_analysis_small_on_cpu():
    out = chip_smoke.phase_analysis(
        "cpu", classify_n=256, ctr_n=4096, k1_n=4096, ring=RING, moe=MOE, seed=5
    )
    assert out["phase"] == "analysis" and "card" not in out
    cli = out["cli"]
    assert cli["rc"] == 0 and cli["active_errors"] == 0
    assert cli["linted"] == cli["swept"] == cli["py_files"] > 0
    assert cli["programs"] > 0
    assert cli["suppressed_by_tool"]["concurrency"] >= 27
    rows = out["families"]
    assert out["families_checked"] == len(rows) == 28
    for row in rows:
        assert row["agree"], row
        assert row["static"]["errors"] == [] and row["runtime"]["syncs"] == 0
        assert row["static"]["collectives"] == [] and row["runtime"]["collectives"] == []
        assert row["static"]["in_place"] is True and row["runtime"]["in_place"] is True
    names = {row["family"] for row in rows}
    assert {"WeightedCalibration[routed]", "MetricTable[windowed_ne]",
            "WindowedMeanSquaredError[watched]", "HistogramBinnedAUROC[sharded]"} <= names
    faults = out["faults"]
    assert faults["item"]["static"] == ["host-callback"] and faults["item"]["runtime"]["syncs"] == 1
    assert faults["all_reduce"]["static"] == ["collective-census"]
    assert faults["all_reduce"]["runtime"]["collectives"] == ["c10d.allreduce_.default"]
    k1 = out["k1"]
    for name in ("auroc", "auprc"):
        assert k1[name]["static_k1_ops"] == 0 and k1[name]["launches"] == [0] * k1["updates"]
        assert k1[name]["bitwise_to_plain"]
    assert out["k1_launches"] == 0
    lock = out["lockstep"]
    assert lock["eager_sync_plan"][0].startswith("allgather_object[acc.") and len(lock["eager_sync_plan"]) == 2
    assert lock["divergent_builder"] == ["rank-divergent-collective"]
    assert lock["ring"]["census"] == {"ppermute": 4, "backward_plan": 1, "ppermute_bwd": 3}
    assert lock["moe"]["census"] == {"all_to_all": 2, "backward_plan": 1, "all_to_all_bwd": 2}


def test_family_table_covers_the_jax_sweep():
    from tests.metrics.test_no_host_sync import CLASS_CASES

    names = set(chip_smoke._analysis_families("cpu", 0))
    assert set(CLASS_CASES) <= names
    assert {f"{n}[watched]" for n in chip_smoke._WATCHABLE} <= names
