"""``chip_smoke.py``'s ``train`` phase (phase 20) at a small size on the
CPU: the probe of a collective inside autograd's own backward node (on
the CPU the nodes run on the rank threads, so it does not deadlock) and
the same swap through ``parallel.backward``; the dp 1 x tp 1 DTensor step
against the plain step with its FLOP count, counters and falling loss;
the ring, MoE and GPipe gradient legs against their dense oracles, over
``ThreadWorld`` ranks and a real ``torch.distributed`` group of world 1
(gloo here, NCCL on the card); the four examples with their markers. The
card-only numbers (event times, TFLOP/s, peak bytes) read None here, and
K1's launches (0 on the CPU) are checked on the card. Also the analytic
counts at the card's sizes."""

from __future__ import annotations

import chip_smoke

SMALL = dict(vocab_size=512, d_model=64, n_heads=4, d_ff=128, max_len=64, n_layers=2)


def test_analytic_counts_at_the_cards_sizes():
    widths = dict(chip_smoke.LLAMA3_8B, n_layers=chip_smoke.TRAIN_LAYERS)
    assert chip_smoke._lm_params(**widths) == 1_822_498_816  # x 16 B = 29.2 GB with Adam
    flops = chip_smoke._lm_flops(**widths, seq=chip_smoke.TRAIN_WINDOW, batch=chip_smoke.TRAIN_BATCH)
    assert flops == 10_900_626_997_248
    assert [int(chip_smoke.MOE_TOKENS / 8 * f) for f in chip_smoke.GRAD_MOE_FACTORS] == [320, 64]


def test_phase_train_small_on_cpu():
    out = chip_smoke.phase_train(
        "cpu", widths=SMALL, layers=2, batch=2, window=32, steps=2, ring_tokens=64, ring_sp=4,
        moe=dict(d_model=16, d_ff=32, experts=8), moe_tokens=64, pp=4, micro=8, micro_len=16,
        scaleout_world=4, seed=3,
    )
    assert out["phase"] == "train" and out["k1_launches"] == 0
    assert out["world1_backend"] == "gloo"
    probe = out["probe"]
    assert not probe["deadlocked"] and probe["backward_on_rank_threads"]
    assert probe["parallel_backward_grads"] == [[3.0] * 4, [2.0] * 4]
    step = out["step"]
    assert step["flops_forward"] == chip_smoke._lm_flops(**SMALL, seq=32, batch=2)
    assert step["flops_backward"] == 2 * step["flops_forward"]
    assert step["counters_step0"]["num_total"] == 64
    assert len(step["losses"]) == 3 and step["losses"][-1] < step["losses"][0]
    assert step["tflops_per_s"] is None and step["peak_bytes"] is None
    ring = out["ring"]
    assert max(ring["max_abs_err"].values()) <= ring["tol"]
    moe = out["moe"]
    assert [v["capacity"] for v in moe["factors"].values()] == [10, 2]
    assert all(v["dropped"] > 0 for v in moe["factors"].values())
    assert out["pipeline"]["ticks"] == 11
    assert out["pipeline"]["max_abs_err"] <= out["pipeline"]["tol"]
    examples = out["examples"]
    assert set(examples) == {"eval_panel", "llm_eval", "multihost", "scaleout"}
    assert examples["multihost"]["result"]["world_size"] == 1
    assert out["k1_streaming_updates"] == 12
