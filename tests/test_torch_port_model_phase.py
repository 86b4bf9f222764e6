"""``chip_smoke.py``'s ``model`` phase (phase 19) at a small size on the
CPU: the eval step's FLOP count, parameter count, counters against the
metric states and the float32 witness; the module summary; the ring
forward over a dp x sp ``ThreadWorld`` against the dense one; MoE with
drops against its oracle; the GPipe schedule against its oracle; each
distributed leg also over a real ``torch.distributed`` group of world 1
(gloo here, NCCL on the card). The card-only numbers (event times,
TFLOP/s, peak bytes) read None here. Also the analytic counts at
Llama-3-8B widths, which the card run holds its counters to."""

from __future__ import annotations

import chip_smoke

SMALL = dict(vocab_size=512, d_model=64, n_heads=4, d_ff=128, max_len=64, n_layers=2)


def test_analytic_counts_at_llama3_8b_widths():
    widths = chip_smoke.LLAMA3_8B
    assert chip_smoke._lm_params(**widths) == chip_smoke.LLAMA3_WIDTH_PARAMS == 6_990_340_096
    flops = chip_smoke._lm_flops(**widths, seq=chip_smoke.LLAMA3_CONTEXT)
    assert flops == chip_smoke.LLAMA3_WIDTH_FLOPS == 140_548_509_794_304
    attention = widths["n_layers"] * 4 * 8192 ** 2 * widths["d_model"]
    assert attention == 35_184_372_088_832  # 3.518e13; matmuls the other 1.0536e14
    assert chip_smoke.MOE_CAPACITY == chip_smoke.MOE_TOKENS // 8 * 5 // 4


def test_phase_model_small_on_cpu():
    out = chip_smoke.phase_model(
        "cpu", widths=SMALL, window=64, steps=2, long_layers=2, dp=2, sp=4,
        moe=dict(d_model=16, d_ff=32, experts=8), moe_tokens=64, moe_capacity=10,
        pp=4, pp_blocks=2, micro=8, micro_len=16, seed=3,
    )
    assert out["phase"] == "model" and out["k1_launches"] == 0
    assert out["world1_backend"] == "gloo"
    ev = out["eval_step"]
    assert ev["parameters"] == chip_smoke._lm_params(**SMALL)
    assert ev["flops_forward"] == chip_smoke._lm_flops(**SMALL, seq=64)
    assert ev["tflops_per_s"] is None and ev["peak_bytes"] is None
    assert ev["float32"]["log_ppl_diff"] <= ev["float32"]["log_ppl_bound"]
    tools = out["tools"]
    assert tools["num_parameters"] == ev["parameters"]
    assert tools["flops_backward"] == 2 * tools["flops_forward"]
    assert tools["backward_bytes_allocated"] == 0
    assert set(tools["forward_ms_by_type"]) >= {"Block", "SelfAttention", "DenseGeneral"}
    lc = out["long_context"]
    assert lc["ppermute_calls_per_rank"] == 2 * 4 and lc["max_abs_err"] <= lc["tol"]
    moe = out["moe"]
    assert moe["dropped"] > 0 and moe["max_abs_err"] <= moe["tol"]
    pipe = out["pipeline"]
    assert pipe["ticks"] == 11 and pipe["max_abs_err"] <= pipe["tol"]
