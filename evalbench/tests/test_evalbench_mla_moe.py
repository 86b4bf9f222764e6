"""The MLA + MoE cell (``moonlight16b_eval``) at a tiny size on the CPU:
its run is correct as it stands, and each fault it can have turns
``correct`` false; its counts, readers and span reduction by hand.

The cut here is the cell's own (``evalbench_tiny.tiny`` cuts the other
cells): three layers (one dense, two MoE) of width 64, 8 routed experts at
k = 3 with a shared expert, MLA with rope and nope parts, a 512-id
vocabulary, 48-token windows. The faults are planted in the program
underneath a run: an update that returns its state unchanged; a capacity
inside the expert layer that keeps each expert's first half of its routed
pairs and sorts the rest past the final offset, where the grouped products
leave them (half the routed pairs dropped).
"""

from __future__ import annotations

import dataclasses
import time

import pytest
import torch
import torch.nn.functional as F

from evalbench import harness, mla_moe_weights, roofline, roofline_mla_moe, spec
from evalbench.model_spans import reduce_model_spans
from torcheval_tpu_torch.metrics import toolkit
from torcheval_tpu_torch.models import MLAMoEConfig, MLAMoELM
from torcheval_tpu_torch.parallel import moe

CELL = "moonlight16b_eval"


def tiny_mla_moe(cell):
    cfg, tr = dict(cell.config), dict(cell.traffic)
    cfg.update(vocab_size=512, hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
               kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
               intermediate_size=128, moe_intermediate_size=32, n_routed_experts=8,
               num_experts_per_tok=3, n_shared_experts=1, max_position_embeddings=64)
    tr.update(window=48, pool_steps=4, checked_steps=2, trace={"start_step": 1, "steps": 1})
    return dataclasses.replace(cell, config=cfg, traffic=tr)


def _run(seconds=1.0, seed=11):
    return harness.run_cell(tiny_mla_moe(spec.cell(CELL)), seed, seconds, False, "cpu",
                            time.perf_counter())


def test_sound_run_is_correct():
    result = _run()
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in spec.cell(CELL).end_to_end}
    assert result["checks"]["route_count_gap"] == {"value": 0.0, "limit": 0.0}
    c = result["counters"]
    assert c["moe_forwards"] == result["attempted"]
    assert c["moe_routed_pairs"] == c["moe_loaded_pairs"] == result["attempted"] * 48 * 3 * 2


def test_unchanged_state_turns_correct_false(monkeypatch):
    monkeypatch.setattr(toolkit, "update_collection", lambda metrics, *a, **k: metrics)
    try:
        result = _run()
    except RuntimeError as e:  # the program refuses to compute: the run fails
        assert "no data" in str(e)
        return
    assert not result["correct"], result["checks"]


def test_half_the_routed_pairs_dropped_turns_correct_false(monkeypatch):
    real = moe._held_groups

    def half(flat, routed, expert_ids, held):
        local, counts = real(flat, routed, expert_ids, held)
        capacity = counts // 2
        arrival = (torch.cumsum(F.one_hot(local, held), 0) - 1).gather(1, local[:, None])[:, 0]
        return torch.where(arrival < capacity[local], local, held), capacity

    monkeypatch.setattr(moe, "_held_groups", half)
    result = _run()
    assert not result["correct"]
    c = result["counters"]
    # each expert computes the floor of half its pairs: at most half a
    # pair more than half dropped an expert of each of the 2 MoE layers
    gap, routed = result["checks"]["route_count_gap"]["value"], c["moe_routed_pairs"]
    assert gap == routed - c["moe_loaded_pairs"]
    assert routed / 2 <= gap <= routed / 2 + 8 / 2 * 2 * c["moe_forwards"]


def test_control_fails_the_cell_limits():
    from evalbench.control_mla_moe import mla_moe_control

    cell = tiny_mla_moe(spec.cell(CELL))
    with torch.no_grad():
        readings = mla_moe_control(cell, 3, "cpu")
    assert "route_count_gap" not in readings
    assert any(not v <= cell.limits[k] for k, v in readings.items()), readings


def test_weights_match_the_program_and_the_step_flops():
    cfg = spec.cell(CELL).config
    shapes = mla_moe_weights.shapes(cfg)
    program = MLAMoELM(MLAMoEConfig.from_dict(cfg), device="meta").named_parameters()
    assert shapes == {name: tuple(p.shape) for name, p in program}
    params = sum(torch.Size(s).numel() for s in shapes.values())
    assert abs(params / 1.596e10 - 1) < 1e-3
    assert abs(roofline_mla_moe.matmul_params_per_token(cfg) / 2.579e9 - 1) < 1e-3
    flops = roofline_mla_moe.forward_flops(cfg, 8192)
    assert abs(flops / 5.154e13 - 1) < 1e-3
    attention = 27 * 8192 ** 2 * 16 * (192 + 128)
    assert flops - 2 * 8192 * roofline_mla_moe.matmul_params_per_token(cfg) == attention
    assert roofline_mla_moe.expert_flops(cfg, 8192) == 2 * 8192 * 6 * 3 * 2048 * 1408 * 26
    assert roofline_mla_moe.expert_bytes(cfg, 8192) == 26 * (64 * 3 * 2048 * 1408 * 2
                                                              + 8192 * 6 * 2 * 2048 * 2)
    least = roofline_mla_moe.expert_least_s(cfg, 8192)
    assert least == roofline_mla_moe.expert_flops(cfg, 8192) / roofline.BF16_PEAK_FLOPS


def test_weights_are_one_aligned_draw():
    cfg = tiny_mla_moe(spec.cell(CELL)).config
    w = mla_moe_weights.weights(cfg, 7, "cpu")
    again = mla_moe_weights.weights(cfg, 7, "cpu")
    assert all(torch.equal(w[k], again[k]) for k in w)
    drawn = [t for k, t in w.items() if not k.endswith("norm")]
    base = drawn[0].untyped_storage().data_ptr()
    assert all(t.untyped_storage().data_ptr() == base for t in drawn)
    assert all(t.storage_offset() % mla_moe_weights.ALIGN == 0 for t in drawn)
    assert all(torch.equal(t, torch.ones_like(t)) for k, t in w.items() if k.endswith("norm"))
    bias = w["layers.1.moe.bias"].float()
    assert 0.005 < float(bias.std()) < 0.06 and float(w["embed"].float().std()) < 0.01


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def test_reduce_model_spans_attributes_device_time_to_every_open_range():
    events = [
        _x("user_annotation", "evalbench.step", 0, 100),
        _x("user_annotation", "torcheval.mla", 5, 20),
        _x("user_annotation", "torcheval.moe.experts", 40, 20),
        _x("user_annotation", "other.range", 0, 100),
        _x("cuda_runtime", "cudaLaunchKernel", 6, 1, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 41, 1, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 70, 1, correlation=3),
        _x("kernel", "attn", 10, 30, correlation=1),
        _x("kernel", "grouped_gemm", 45, 40, correlation=2),
        _x("kernel", "head", 90, 10, correlation=3),
        _x("kernel", "unmatched", 200, 5, correlation=9),
    ]
    r = reduce_model_spans(events)
    per = r["range_device_s"]
    assert per["evalbench.step"] == pytest.approx(80e-6)
    assert per["torcheval.mla"] == pytest.approx(30e-6)
    assert per["torcheval.moe.experts"] == pytest.approx(40e-6)
    assert "other.range" not in per
    assert r["busy_s"] == pytest.approx((30 + 40 + 10 + 5) * 1e-6)
    assert reduce_model_spans(events[:4]) is None


def test_readers_read_the_model_spans_and_find_nothing_without_them():
    cell = spec.cell(CELL)
    readers = spec.readers(cell)
    assert {"moe_step_mfu", "expert_share_pct", "expert_roofline", "mla_share_pct",
            "bridge_share_pct", "bridge_roofline", "device_idle_pct.lm"} == set(readers)
    cfg = cell.config
    least = roofline_mla_moe.expert_least_s(cfg, 8192)
    record = {"step_s": [0.2, 0.25, 0.3], "config": cfg, "window": 8192, "windows_per_step": 1,
              "tokens_per_step": 8192, "traced_steps": 2,
              "model_spans": {"steps": 2, "busy_s": 0.5,
                              "range_device_s": {"evalbench.step": 0.5, "torcheval.mla": 0.1,
                                                 "torcheval.moe.experts": 4 * least}}}
    assert readers["expert_share_pct"].read(record) == pytest.approx(100 * 4 * least / 0.5)
    assert readers["mla_share_pct"].read(record) == pytest.approx(20.0)
    assert readers["expert_roofline"].read(record) == pytest.approx(50.0)
    mfu = roofline_mla_moe.forward_flops(cfg, 8192) / roofline.BF16_PEAK_FLOPS / 0.25 * 100
    assert readers["moe_step_mfu"].read(record) == pytest.approx(mfu)
    bare = dict(record, model_spans=None)
    for name in ("expert_share_pct", "mla_share_pct", "expert_roofline"):
        assert readers[name].read(bare) is None
    gpt2 = spec.cell("gpt2xl_eval").config
    assert readers["moe_step_mfu"].read(dict(record, config=gpt2)) is None
