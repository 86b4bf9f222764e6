"""The DeepSeek-V3-family LM (``models/mla_moe.py``) and the dropless
top-k expert layer (``parallel/moe.py``) against the benchmark's plain
reference (``evalbench/reference/mla_moe.py``), at a tiny size on the CPU
that keeps every part: a dense first layer, two MoE layers of 8 routed
experts at k = 3 with a shared expert, MLA with rope and nope parts, an
untied head.

Tolerances (float32 logits against the reference's, as a share of the
reference's RMS):

- ``F32_TOL`` 1e-5: both compute in float32; they differ in the order of
  sums (one attention call against query blocks, grouped products and one
  batched weighted sum against a loop of experts), ~1e-7 relative a sum;
- ``BF16_TOL`` 0.05: the program in bfloat16 (every weight, activation and
  logit rounded to 8 bits of mantissa, ~0.4 % an op) against float32,
  where bfloat16 routes every token to the experts float32 routes it to
  (1.2-1.5 % over 30 seeds);
- ``ROUTE_FLIP_TOL`` 0.25, where it does not: a near-tie in a router's
  scores that bfloat16 breaks the other way swaps one of a token's
  experts, and the logits move by far more than rounding (3-16 % on 24
  of 30 seeds on the CPU).

Each mutation (a routing, attention or norm detail left out) moves the
float32 logits by far more than ``F32_TOL``. The card test holds a forward
to no host synchronisation (``set_sync_debug_mode("error")``); it skips
without a card and runs on the chip. This file imports no JAX.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch
import torch.nn.functional as F

from evalbench import mla_moe_weights
from evalbench.reference import mla_moe as ref
from torcheval_tpu_torch.models import MLAMoEConfig, MLAMoELM
from torcheval_tpu_torch.models import mla_moe as model_module
from torcheval_tpu_torch.parallel import moe
from torcheval_tpu_torch.utils.test_utils import ThreadWorld

F32_TOL = 1e-5
BF16_TOL = 0.05
ROUTE_FLIP_TOL = 0.25
TINY = dict(vocab_size=97, hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
            kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=12,
            intermediate_size=96, moe_intermediate_size=24, n_routed_experts=8,
            n_shared_experts=1, num_experts_per_tok=3, first_k_dense_replace=1,
            norm_topk_prob=True, routed_scaling_factor=2.446, rms_norm_eps=1e-5,
            rope_theta=50000.0, max_position_embeddings=64,
            # large enough that every mechanism moves the logits at this width
            init_std=0.15, e_score_correction_bias_std=0.1)
SEQ = 24


def _weights(dtype=torch.float32, seed=5, **over):
    return mla_moe_weights.weights(dict(TINY, **over), seed, "cpu", dtype=dtype)


def _model(weights, dtype=torch.float32, **over):
    model = MLAMoELM(MLAMoEConfig.from_dict(dict(TINY, **over)), device="meta", dtype=dtype)
    model.load_state_dict({k: v.to(dtype) for k, v in weights.items()}, assign=True)
    return model


def _tokens(batch=2, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, TINY["vocab_size"], (batch, SEQ), generator=g)


def _rel(got, want):
    return float((got.float() - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt())


@pytest.fixture
def setting():
    weights = _weights()
    tokens = _tokens()
    with torch.no_grad():
        want = ref.forward(weights, tokens, TINY)
    return weights, tokens, want


def test_weights_are_named_and_shaped_as_the_program_at_full_width():
    full = {k: v for k, v in TINY.items() if k not in MLAMoEConfig.__dataclass_fields__}
    cfg = dict(dataclasses.asdict(MLAMoEConfig()), **full)
    program = MLAMoELM(MLAMoEConfig(), device="meta").named_parameters()
    assert mla_moe_weights.shapes(cfg) == {name: tuple(p.shape) for name, p in program}


@pytest.mark.parametrize("batch", (1, 2))
def test_float32_forward_matches_the_reference(batch):
    weights, tokens = _weights(), _tokens(batch)
    with torch.no_grad():
        got = _model(weights)(tokens)
        want = ref.forward(weights, tokens, TINY)
    assert got.shape == (batch, SEQ, TINY["vocab_size"])
    assert _rel(got, want) < F32_TOL


def _routed(model, tokens, monkeypatch):
    """The logits and each MoE layer's chosen experts (sorted a token)."""
    real, chosen = moe.route_topk, []

    def keep(*args):
        choice, weight = real(*args)
        chosen.append(choice.sort(dim=-1).values)
        return choice, weight

    monkeypatch.setattr(moe, "route_topk", keep)
    with torch.no_grad():
        out = model(tokens)
    monkeypatch.setattr(moe, "route_topk", real)
    return out, chosen


@pytest.mark.parametrize("seed", range(6))
def test_bfloat16_forward_matches_the_reference(seed, monkeypatch):
    """``BF16_TOL`` where bfloat16 chose the float32 experts for every
    token, else ``ROUTE_FLIP_TOL``."""
    bf16, tokens = _weights(torch.bfloat16, seed=seed), _tokens(seed=seed)
    got, chosen = _routed(_model(bf16, torch.bfloat16), tokens, monkeypatch)
    _, chosen32 = _routed(_model(bf16.copy()), tokens, monkeypatch)
    with torch.no_grad():
        want = ref.forward(bf16, tokens, TINY)
    flipped = any(not torch.equal(a, b) for a, b in zip(chosen, chosen32))
    assert got.dtype == torch.bfloat16
    assert _rel(got, want) < (ROUTE_FLIP_TOL if flipped else BF16_TOL)


def _bias_weights(monkeypatch):
    def route(x, w, bias, k, norm=True, scale=1.0):
        scores = torch.sigmoid(x.float() @ w.float().t()) + bias.float()
        choice = torch.topk(scores, k, dim=-1).indices
        weight = scores.gather(1, choice)
        return choice, weight / weight.sum(-1, keepdim=True) * scale

    monkeypatch.setattr(moe, "route_topk", route)


def _softmax_router(monkeypatch):
    def route(x, w, bias, k, norm=True, scale=1.0):
        scores = torch.softmax(x.float() @ w.float().t(), dim=-1)
        choice = torch.topk(scores + bias.float(), k, dim=-1).indices
        weight = scores.gather(1, choice)
        return choice, weight / weight.sum(-1, keepdim=True) * scale

    monkeypatch.setattr(moe, "route_topk", route)


def _no_kv_a_norm(monkeypatch):
    real = model_module.rms_norm
    monkeypatch.setattr(model_module, "rms_norm",
                        lambda x, scale, eps: x if x.shape[-1] == TINY["kv_lora_rank"]
                        else real(x, scale, eps))


def _no_rope(monkeypatch):
    monkeypatch.setattr(model_module, "apply_rope", lambda x, cos, sin: x)


def _no_topk_norm(monkeypatch):
    real = moe.route_topk
    monkeypatch.setattr(moe, "route_topk",
                        lambda x, w, b, k, norm=True, scale=1.0: real(x, w, b, k, False, scale))


@pytest.mark.parametrize("mutate", (_bias_weights, _softmax_router, _no_kv_a_norm, _no_rope,
                                    _no_topk_norm),
                         ids=("bias_also_weights", "softmax_router", "no_kv_a_norm", "no_rope",
                              "no_topk_norm"))
def test_each_mutation_fails_the_comparison(mutate, setting, monkeypatch):
    weights, tokens, want = setting
    mutate(monkeypatch)
    with torch.no_grad():
        got = _model(weights)(tokens)
    assert _rel(got, want) > 100 * F32_TOL


def _layer(seed=3, n=40, d=16, experts=8, f=12, fs=10):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    return dict(x=r(n, d), router_weight=r(experts, d) * 0.3, correction_bias=r(experts) * 0.1,
                gate_up=r(experts, d, 2 * f) * 0.2, down=r(experts, f, d) * 0.2,
                shared=(r(d, 2 * fs) * 0.2, r(fs, d) * 0.2))


KW = dict(k=3, norm_topk_prob=True, routed_scaling_factor=2.446)


def test_dropless_layer_matches_its_oracle_and_loads_sum_to_tokens_times_k():
    p = _layer()
    key = ("cpu", p["router_weight"].data_ptr())
    before = moe.moe_counts()
    got = moe.moe_topk_dropless(**p, **KW)
    after, loads = moe.moe_counts(), moe._LOADS[key]
    want = moe.moe_topk_reference(**p, **KW)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    n = p["x"].shape[0]
    assert after["routed_pairs"] - before["routed_pairs"] == n * KW["k"]
    assert after["loaded_pairs"] - before["loaded_pairs"] == n * KW["k"]
    choice, _ = moe.route_topk(p["x"], p["router_weight"], p["correction_bias"], KW["k"])
    assert torch.equal(loads, torch.bincount(choice.reshape(-1), minlength=8))


@pytest.mark.parametrize("shares", ((0, 8), (0, 3, 8), (0, 2, 4, 6, 8), (0, 1, 5, 8)))
def test_held_expert_shares_sum_to_the_whole_layer(shares):
    """The shares of the experts, each computed with only its own experts
    held and the shared expert added by one share, sum to the layer."""
    p = _layer()
    whole = moe.moe_topk_dropless(**p, **KW)
    total = torch.zeros_like(whole)
    before = moe.moe_counts()
    for i, (lo, hi) in enumerate(zip(shares[:-1], shares[1:])):
        ids = torch.arange(lo, hi)
        part = dict(p, gate_up=p["gate_up"][lo:hi], down=p["down"][lo:hi],
                    shared=p["shared"] if i == 0 else None)
        got = moe.moe_topk_dropless(**part, expert_ids=ids, **KW)
        torch.testing.assert_close(got, moe.moe_topk_reference(**part, expert_ids=ids, **KW),
                                   rtol=1e-5, atol=1e-5)
        total += got
    torch.testing.assert_close(total, whole, rtol=1e-5, atol=1e-5)
    # each share computes its own experts' pairs: together, every pair once
    assert moe.moe_counts()["loaded_pairs"] - before["loaded_pairs"] == p["x"].shape[0] * KW["k"]


@pytest.mark.parametrize("capacity, regroup", ((0, True), (2, True), (4, True), (4, False)),
                         ids=("capacity_0", "capacity_2", "capacity_4", "short_offsets_4"))
def test_a_capped_group_shows_in_the_loaded_pairs(capacity, regroup, monkeypatch):
    """A fault planted inside the layer: each expert's group capped at
    ``capacity`` pairs, either as a capacity would (its first pairs kept,
    the rest sorted past the final offset) or by its offsets alone. The
    grouped products then compute fewer pairs than were routed, and
    ``loaded_pairs`` falls short of ``routed_pairs`` by as many."""
    real = moe._held_groups

    def capped(flat, routed, expert_ids, held):
        local, counts = real(flat, routed, expert_ids, held)
        if regroup:
            arrival = (torch.cumsum(F.one_hot(local, held), 0) - 1).gather(1, local[:, None])[:, 0]
            local = torch.where(arrival < capacity, local, held)
        return local, counts.clamp(max=capacity)

    monkeypatch.setattr(moe, "_held_groups", capped)
    p = _layer()
    n = p["x"].shape[0]
    choice, _ = moe.route_topk(p["x"], p["router_weight"], p["correction_bias"], KW["k"])
    dropped = int((torch.bincount(choice.reshape(-1), minlength=8) - capacity).clamp(min=0).sum())
    assert dropped > 0
    before = moe.moe_counts()
    moe.moe_topk_dropless(**p, **KW)
    after = moe.moe_counts()
    assert after["routed_pairs"] - before["routed_pairs"] == n * KW["k"]
    assert after["loaded_pairs"] - before["loaded_pairs"] == n * KW["k"] - dropped


def test_expert_axis_sums_the_shares_and_adds_the_shared_experts_once():
    p = _layer()
    whole = moe.moe_topk_dropless(**p, **KW)

    def rank(g):
        lo, hi = 2 * g.rank, 2 * g.rank + 2
        return moe.moe_topk_dropless(**dict(p, gate_up=p["gate_up"][lo:hi], down=p["down"][lo:hi]),
                                     expert_ids=torch.arange(lo, hi), group=g, **KW)

    for got in ThreadWorld(4, timeout=60).run(rank):
        torch.testing.assert_close(got, whole, rtol=1e-5, atol=1e-5)


def test_forward_counts_every_routed_pair_of_every_moe_layer(setting):
    weights, tokens, _ = setting
    model = _model(weights)
    before = moe.moe_counts()
    with torch.no_grad():
        model(tokens)
    after = moe.moe_counts()
    pairs = tokens.numel() * TINY["num_experts_per_tok"] * 2
    assert after["forwards"] - before["forwards"] == 1
    assert after["routed_pairs"] - before["routed_pairs"] == pairs
    assert after["loaded_pairs"] - before["loaded_pairs"] == pairs
    assert after["load_max_over_mean"] >= 1.0


def test_config_refuses_what_is_not_implemented():
    for key, value in (("q_lora_rank", 1536), ("n_group", 8), ("scoring_func", "softmax"),
                       ("tie_word_embeddings", True)):
        with pytest.raises(ValueError, match=key):
            MLAMoEConfig.from_dict(dict(TINY, **{key: value}))
    assert MLAMoEConfig.from_dict({"q_lora_rank": None, "n_group": 1}) == MLAMoEConfig()


def test_rope_turns_adjacent_pairs():
    cos, sin = model_module.rope_tables(5, 4, 100.0, "cpu")
    x = torch.tensor([[1.0, 0.0, 0.0, 1.0]]).expand(5, 4)
    got = model_module.apply_rope(x, cos, sin)
    pos = torch.arange(5.0)
    torch.testing.assert_close(got[:, 0], torch.cos(pos))
    torch.testing.assert_close(got[:, 1], torch.sin(pos))
    torch.testing.assert_close(got[:, 2], -torch.sin(pos / 10.0))
    torch.testing.assert_close(got[:, 3], torch.cos(pos / 10.0))


def test_forward_makes_no_host_sync_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: set_sync_debug_mode watches CUDA synchronisations")
    dev = torch.device("cuda", torch.cuda.current_device())
    weights = mla_moe_weights.weights(TINY, 5, dev)
    model = MLAMoELM(MLAMoEConfig.from_dict(TINY), device="meta", dtype=torch.bfloat16)
    model.load_state_dict(weights, assign=True)
    tokens = _tokens().to(dev)
    with torch.no_grad():
        want = model(tokens)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = model(tokens)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert torch.equal(got, want)
        fwant = ref.forward(weights, tokens, TINY)
    assert _rel(got, fwant) < ROUTE_FLIP_TOL


def test_counts_lose_no_update_across_threads():
    """Expert-layer calls on many threads (the ranks of a ``ThreadWorld``)
    at once: every routed pair and every load is counted."""
    import sys
    import threading

    router = torch.zeros(5, 3)
    threads, calls = 12, 200
    before = moe.moe_counts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [moe._count_loads(
            torch.ones(5, dtype=torch.int64), 5, router) for _ in range(calls)])
            for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    after = moe.moe_counts()
    assert after["routed_pairs"] - before["routed_pairs"] == threads * calls * 5
    assert torch.equal(moe._LOADS[("cpu", router.data_ptr())], torch.full((5,), threads * calls))


def test_a_flop_count_routes_nothing():
    """``tools.count_flops`` runs the forward on fake tensors: it counts as
    a forward, and no pair or load, and the counters still read."""
    from torcheval_tpu_torch.tools import count_flops

    model = _model(_weights(torch.bfloat16), torch.bfloat16)
    before = moe.moe_counts()
    assert count_flops(model, _tokens()) > 0
    after = moe.moe_counts()
    assert after["forwards"] - before["forwards"] == 1
    assert (after["routed_pairs"], after["loaded_pairs"]) == (before["routed_pairs"],
                                                              before["loaded_pairs"])
