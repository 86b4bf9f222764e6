"""``chip_smoke.py``'s ``wan`` phase (phase 18) at a small size on the
CPU: the wire ladder at every rung against its codec bounds, the breach
fallback, the sync plane's read against the blocking sync, the federation
through a partition and a heal against the flat sync, and the three kills
of the failover arm with their loss bounds, oracles and live rejoins. The
card-only parts (K1's launches, the NCCL in-step sync, device times, the
host-sync check inside ``publish``) need the card; the spawned gloo
in-step sync runs in ``test_torch_port_sharded.py``."""

from __future__ import annotations

import chip_smoke

CPU = "cpu"


def test_phase_wan_small_on_cpu():
    out = chip_smoke.phase_wan(
        CPU, n=40 * 512, batch=512, batches=12, world=4, num_bins=64, classes=20, window=1024,
        wire_batches=8, interval=0.2, blocking_every=3, fed_rounds=6, partition_after=2,
        fail_steps=20, rows=5000, hist_bins=4096, hist_steps=2, mp=False, seed=3,
    )
    assert out["phase"] == "wan" and out["k1_launches"] == 0
    wire = out["wire"]
    assert wire["rungs"]["int8"]["wire_tier"]["exact"] == "int8"
    assert wire["rungs"]["int8"]["wire_tier"]["cm"] == "exact"
    assert wire["int8_reduction"] > wire["bf16_reduction"] > 1.0
    assert wire["fallback"]["wire_tier"] == ["bf16", "exact"]
    plane = out["plane"]
    assert plane["read_bitwise_to_blocking"] and plane["serving_gathers"] == [0, 0, 0, 0]
    assert min(plane["rounds"]) >= 1
    fed = out["federation"]
    assert fed["healthz_dark"] == "stale-region" and fed["duplicates_discarded"] >= 1
    assert fed["dark_provenance"]["merged_regions"] == ["us"]
    fo = out["failover"]
    assert [k["victim"] for k in fo["kills"]] == [3, 3, 2]
    assert fo["kills"][0]["loss"]["exact"] and fo["kills"][1]["loss"]["steps"] == 5
    assert fo["poll_gathers"] == 0 and fo["panel_captures_after_warmup"] == 0


def test_phase_wan_in_step_int8_over_two_gloo_processes():
    """The wire arm's in-step ``compression="int8"`` sync of the histogram
    AUROC over two spawned gloo processes: the int32 counts bitwise, the
    float32 histogram within its codec bound, one quantizer call an owner
    block."""
    out = chip_smoke._wan_in_step(CPU, 7, 4096, 512, 2, True)["gloo_world2"]
    assert out["max_abs_err"] <= out["bound"] and out["quantizer_calls"] == [2, 2]
