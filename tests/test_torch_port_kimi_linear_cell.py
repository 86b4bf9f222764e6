"""The Kimi Linear cell (``kimilinear48b_eval_32k``) at a tiny size on the
CPU: its run is correct as it stands and each planted fault turns
``correct`` false; its control fails the cell's limits; the work
``evalbench/roofline_kimi_linear.py`` counts at the published widths,
against hand sums; and its readers.

The cut here is the cell's own: four layers of width 64 (three KDA layers
of 2 heads of 16, one NoPE MLA layer), a dense first layer, MoE layers
holding 2 of 8 experts at k = 3 with a shared expert, a 512-id vocabulary,
48-token windows. This file imports no JAX.
"""

from __future__ import annotations

import dataclasses
import time

import pytest
import torch
import torch.nn.functional as F

from evalbench import harness, roofline, roofline_kimi_linear, spec
from torcheval_tpu_torch.metrics import toolkit
from torcheval_tpu_torch.parallel import moe

CELL = "kimilinear48b_eval_32k"


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads while a test here runs: beside other test
    processes, a full set of threads a process makes each tiny op wait on
    the others' cores, and a timed window then runs too few steps."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def tiny_kimi(cell):
    cfg, tr = dict(cell.config), dict(cell.traffic)
    cfg.update(vocab_size=512, hidden_size=64, num_hidden_layers=4, num_attention_heads=4,
               kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
               intermediate_size=128, moe_intermediate_size=32, num_experts=2,
               router_experts=8, num_experts_per_token=3, num_shared_experts=1,
               linear_attn_config=dict(kda_layers=[1, 2, 4], full_attn_layers=[3], head_dim=16,
                                       num_heads=2, short_conv_kernel_size=4))
    # both pool steps checked: a window of two steps, however slow the
    # machine, runs them
    tr.update(window=48, pool_steps=2, checked_steps=2, trace={"start_step": 1, "steps": 1})
    return dataclasses.replace(cell, config=cfg, traffic=tr)


def _run(seconds=2.0, seed=11):
    return harness.run_cell(tiny_kimi(spec.cell(CELL)), seed, seconds, False, "cpu",
                            time.perf_counter())


def test_sound_run_is_correct():
    result = _run()
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in spec.cell(CELL).end_to_end}
    assert result["checks"]["route_count_gap"] == {"value": 0.0, "limit": 0.0}
    load = result["checks"]["route_load_gap"]
    assert 0 <= load["value"] <= load["limit"] < 0.5
    c = result["counters"]
    assert c["moe_forwards"] == result["attempted"]
    assert c["moe_routed_pairs"] == result["attempted"] * 48 * 3 * 3
    assert 0 < c["moe_held_pairs"] == c["moe_loaded_pairs"] < c["moe_routed_pairs"]
    assert c["kda_launches"] == 0  # the CPU runs the scan as ops


def test_unchanged_state_turns_correct_false(monkeypatch):
    monkeypatch.setattr(toolkit, "update_collection", lambda metrics, *a, **k: metrics)
    try:
        result = _run()
    except RuntimeError as e:  # the program refuses to compute: the run fails
        assert "no data" in str(e)
        return
    assert not result["correct"], result["checks"]


def test_half_the_held_pairs_dropped_turns_correct_false(monkeypatch):
    real = moe._held_groups

    def half(flat, routed, expert_ids, held):
        local, counts = real(flat, routed, expert_ids, held)
        capacity = counts // 2
        kept = local < held
        arrival = (torch.cumsum(F.one_hot(local, held + 1), 0) - 1).gather(1, local[:, None])[:, 0]
        keep = kept & (arrival < capacity[local.clamp(max=held - 1)])
        return torch.where(keep, local, held), capacity

    monkeypatch.setattr(moe, "_held_groups", half)
    result = _run()
    assert not result["correct"]
    c = result["counters"]
    assert c["moe_held_pairs"] > c["moe_loaded_pairs"] > 0
    # the held experts' loads against the reference's own routing: about
    # half of each missing
    gap = result["checks"]["route_load_gap"]
    assert 0.4 < gap["value"] and gap["value"] > gap["limit"]
    assert result["checks"]["route_count_gap"]["value"] == 0
    assert c["moe_routed_pairs"] == result["attempted"] * 48 * 3 * 3


def test_other_experts_held_than_the_weights_turns_correct_false(monkeypatch):
    """The program holding experts 1 and 2 where the reference holds 0 and
    1: the grouped products compute other experts' pairs."""
    from torcheval_tpu_torch.models import kimi_linear as model_module

    real = model_module.KimiLinearConfig.from_dict.__func__

    def shifted(cls, config):
        return dataclasses.replace(real(cls, config), held_expert_start=1)

    monkeypatch.setattr(model_module.KimiLinearConfig, "from_dict", classmethod(shifted))
    result = _run()
    assert not result["correct"]
    gap = result["checks"]["route_load_gap"]
    assert gap["value"] > gap["limit"], result["checks"]


def test_control_fails_the_cell_limits():
    from evalbench.control_kimi_linear import kimi_linear_control

    cell = tiny_kimi(spec.cell(CELL))
    with torch.no_grad():
        readings = kimi_linear_control(cell, 3, "cpu")
    assert "route_count_gap" not in readings
    assert readings["route_load_gap"] > 0
    assert any(not v <= cell.limits[k] for k, v in readings.items()), readings


# ------------------------------------------------------------ the counts

def test_scan_counts_at_the_published_widths():
    cfg = spec.cell(CELL).config
    c, d = 64, 128
    per_chunk = (c * (c - 1) // 2 * d      # A
                 + c * (c + 1) // 2 * d    # M
                 + c * (c - 1) // 2 * 2 * d  # the solve, [W_k | W_v]
                 + 3 * c * d * d           # W_k S, Q S, the state update
                 + c * (c + 1) // 2 * d)   # M U
    assert per_chunk == 4_452_352
    assert roofline_kimi_linear.kda_scan_flops(cfg, 32768) == 2 * 32 * 512 * per_chunk
    # q, k, v, o in bf16, g in float32, beta float32, a token a head
    assert roofline_kimi_linear.kda_scan_bytes(cfg, 32768) == 32768 * 32 * (
        2 * 128 * 4 + 4 * 128 + 4)
    least = roofline_kimi_linear.kda_scan_least_s(cfg, 32768)
    assert least == roofline_kimi_linear.kda_scan_bytes(cfg, 32768) / roofline.HBM_BYTES_PER_S
    assert abs(least * 1e3 / 0.482 - 1) < 0.01


def test_conv_counts_at_the_published_widths():
    """``chip_smoke.py``'s bounds of the KDA kernels at the cell's layer:
    the convolutions' and the scan's bytes."""
    import chip_smoke

    cfg = spec.cell(CELL).config
    channels = 3 * 32 * 128
    conv = chip_smoke._kda_conv_bound_bytes(1, 32768, 32, 128)
    assert conv == 2 * 32768 * channels * 2
    assert abs(conv / roofline.HBM_BYTES_PER_S * 1e3 / 0.481 - 1) < 0.01
    assert chip_smoke._kda_bound_bytes(1, 32768, 32, 128) == roofline_kimi_linear.kda_scan_bytes(
        cfg, 32768)


def test_held_expert_counts_at_the_published_widths():
    cfg = spec.cell(CELL).config
    d, f = 2304, 1024
    pairs = 2 * 32768 * 8 * 26 // 4  # two steps, a quarter of the pairs held
    assert roofline_kimi_linear.held_expert_flops(cfg, pairs) == 2 * pairs * 3 * d * f
    weights = 2 * 26 * 64 * 3 * d * f * 2
    assert roofline_kimi_linear.held_expert_bytes(cfg, pairs, 2) == weights + pairs * 2 * d * 2
    least = roofline_kimi_linear.held_expert_least_s(cfg, pairs, 2)
    assert least == roofline_kimi_linear.held_expert_flops(cfg, pairs) / roofline.BF16_PEAK_FLOPS
    assert abs(least * 1e3 / 2 / 24.4 - 1) < 0.01  # ~24.4 ms a step at the bf16 peak


def test_step_flops_at_the_published_widths():
    cfg = spec.cell(CELL).config
    d, v = 2304, 163_840
    kda = (d * 3 * 4096 + d * (2 * 128 + 32) + 2 * 128 * 4096 + 4096 * d  # projections
           + 3 * 4096 * 4)                                                  # conv taps
    mla = d * 32 * 192 + d * (512 + 64) + 512 * 32 * 256 + 32 * 128 * d
    dense = 3 * d * 9216
    moe_layer = d * 256 + 8 * 3 * d * 1024 * 64 // 256 + 3 * d * 1024
    params = 20 * kda + 7 * mla + dense + 26 * moe_layer + d * v
    assert params == 2_002_599_936
    assert roofline_kimi_linear.matmul_params_per_token(cfg) == params
    attention = 7 * 32768 ** 2 * 32 * (192 + 128)
    scans = 20 * roofline_kimi_linear.kda_scan_flops(cfg, 32768)
    flops = roofline_kimi_linear.forward_flops(cfg, 32768)
    assert flops == 2 * 32768 * params + attention + scans
    assert abs(flops / 2.1e14 - 1) < 0.01


def test_readers_read_the_model_spans_and_find_nothing_without_them():
    cell = spec.cell(CELL)
    readers = spec.readers(cell)
    assert set(readers) == {"bridge_share_pct", "bridge_roofline", "device_idle_pct.lm",
                            "mla_share_pct", "expert_share_pct", "kda_share_pct",
                            "kda_roofline", "hybrid_step_mfu", "held_expert_roofline"}
    cfg = cell.config
    layer = roofline_kimi_linear.kda_scan_least_s(cfg, 32768)
    flops = roofline_kimi_linear.forward_flops(cfg, 32768)
    pairs = 2 * 32768 * 8 * 26 // 4
    held = roofline_kimi_linear.held_expert_least_s(cfg, pairs, 2)
    record = {"step_s": [0.5, 0.6, 0.7], "config": cfg, "window": 32768, "windows_per_step": 1,
              "tokens_per_step": 32768, "traced_steps": 2, "step_flops": flops,
              "model_span_held_pairs": pairs,
              "model_spans": {"steps": 2, "busy_s": 1.2,
                              "range_device_s": {"evalbench.step": 1.2, "torcheval.kda": 0.3,
                                                 "torcheval.kda.scan": 2 * 20 * layer * 4,
                                                 "torcheval.mla": 0.24,
                                                 "torcheval.moe.experts": held * 5}}}
    assert readers["kda_share_pct"].read(record) == pytest.approx(25.0)
    assert readers["kda_roofline"].read(record) == pytest.approx(25.0)
    assert readers["mla_share_pct"].read(record) == pytest.approx(20.0)
    assert readers["expert_share_pct"].read(record) == pytest.approx(held * 5 / 1.2 * 100)
    assert readers["held_expert_roofline"].read(record) == pytest.approx(20.0)
    mfu = flops / roofline.BF16_PEAK_FLOPS / 0.6 * 100
    assert readers["hybrid_step_mfu"].read(record) == pytest.approx(mfu)
    bare = dict(record, model_spans=None, step_flops=None)
    for name in ("kda_share_pct", "kda_roofline", "hybrid_step_mfu", "held_expert_roofline"):
        assert readers[name].read(bare) is None
    assert readers["held_expert_roofline"].read(dict(record, model_span_held_pairs=None)) is None
    moonlight = spec.cell("moonlight16b_eval").config
    assert readers["kda_roofline"].read(dict(record, config=moonlight)) is None
