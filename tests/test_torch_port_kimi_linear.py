"""Kimi Linear (``models/kimi_linear.py``), its KDA scan and short
convolutions (``ops/kda.py``) and the held-expert layer, against the
benchmark's plain reference (``evalbench/reference/kimi_linear.py``) at
tiny sizes on the CPU: T = 200 tokens of 2 heads of 16 for the scan, and a
four-layer model with both kinds of token mixer (three KDA, one NoPE MLA), a
dense first layer and MoE layers holding 2 of 8 experts (ids 2 and 3).

Tolerances:

- ``SCAN_TOL`` 2e-5 of the largest output: ``kda_ops`` computes the
  chunked algebra in float32 against the float64 token-by-token
  recurrence; sums of a few hundred float32 terms (~1e-7 each) and the
  triangular solve's conditioning (at most ~1e1 here) stay well inside;
- ``F32_TOL`` 1e-5 of the logits' RMS: the model and the reference both in
  float32, differing in the order of sums (chunked scan against the
  recurrence, grouped products against a loop of experts, one attention
  call against query blocks).

Each mutation (a part of the equations left out or changed) moves the
float32 logits by far more than ``F32_TOL``. The card tests (``card``
marker) hold the kernels to the op sequences and a forward to no host
synchronisation; they skip without CUDA. This file imports no JAX.
"""

from __future__ import annotations

import pytest
import torch

from evalbench import kimi_linear_weights
from evalbench.reference import kimi_linear as ref
from torcheval_tpu_torch.models import KimiLinearConfig, KimiLinearLM, MLAMoEConfig
from torcheval_tpu_torch.models import kimi_linear as model_module
from torcheval_tpu_torch.models.mla_moe import MoE
from torcheval_tpu_torch.ops import _kernels, kda
from torcheval_tpu_torch.parallel import moe

SCAN_TOL = 2e-5
F32_TOL = 1e-5
TINY = dict(vocab_size=97, hidden_size=64, num_hidden_layers=4, num_attention_heads=4,
            kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=12,
            intermediate_size=96, moe_intermediate_size=24, num_experts=2, router_experts=8,
            held_expert_start=2, num_experts_per_token=3, num_shared_experts=1,
            first_k_dense_replace=1, moe_renormalize=True, routed_scaling_factor=2.446,
            rms_norm_eps=1e-5, rope_theta=10000.0, mla_use_nope=True,
            linear_attn_config=dict(kda_layers=[1, 2, 4], full_attn_layers=[3], head_dim=16,
                                    num_heads=2, short_conv_kernel_size=4),
            # large enough that every mechanism moves the logits at this width
            init_std=0.15, conv_init_std=0.289, e_score_correction_bias_std=0.1)
SEQ = 40


def _scan_inputs(t=200, b=2, h=2, d=16, g_low=-0.5, seed=0, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    norm = torch.nn.functional.normalize
    q = norm(torch.randn(b, t, h, d, generator=gen), dim=-1)
    k = norm(torch.randn(b, t, h, d, generator=gen), dim=-1)
    v = torch.randn(b, t, h, d, generator=gen)
    g = torch.rand(b, t, h, d, generator=gen) * g_low
    beta = torch.rand(b, t, h, generator=gen)
    return [x.to(dtype) for x in (q, k, v, g, beta)]


def _max_rel(got, want):
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


@pytest.mark.parametrize("chunk", (16, 64))
@pytest.mark.parametrize("t, g_low", ((200, -0.5), (64, -0.5), (200, -20.0)),
                         ids=("ragged", "one_chunk", "strong_decay"))
def test_kda_ops_matches_the_token_recurrence(chunk, t, g_low):
    """T not a multiple of the chunk, one whole chunk, and decays down to
    -20 a step (exp(-cumsum) would overflow float32 within 5 steps)."""
    q, k, v, g, beta = _scan_inputs(t=t, g_low=g_low)
    got = kda.kda_ops(q, k, v, g, beta, 16 ** -0.5, chunk=chunk)
    want = ref.kda_recurrence(*(x.double() for x in (q, k, v, g, beta)), 16 ** -0.5)
    assert got.shape == v.shape and got.dtype == v.dtype
    assert torch.isfinite(got).all()
    assert _max_rel(got, want) < SCAN_TOL


def test_kda_ops_bf16_state_rounds_between_chunks():
    """The control's bfloat16-state scan (``control_kimi_linear``) is
    ``kda_ops`` but for the state's rounding after each chunk."""
    from evalbench.control_kimi_linear import kda_ops_bf16_state

    q, k, v, g, beta = _scan_inputs()
    want = kda.kda_ops(q, k, v, g, beta, 0.25)
    got = kda_ops_bf16_state(q, k, v, g, beta, 0.25)
    assert 0 < _max_rel(got, want) < 0.05
    one = _scan_inputs(t=64)  # one chunk: the state is rounded only after it
    torch.testing.assert_close(kda_ops_bf16_state(*one, 0.25), kda.kda_ops(*one, 0.25),
                               rtol=1e-6, atol=1e-6)


def test_kda_chunked_on_the_cpu_is_the_op_sequence():
    q, k, v, g, beta = _scan_inputs(t=70)
    assert not kda.takes(q, k, v, g, beta)
    before = dict(_kernels.LAUNCHES)
    torch.testing.assert_close(kda.kda_chunked(q, k, v, g, beta, 0.25),
                               kda.kda_ops(q, k, v, g, beta, 0.25), rtol=0, atol=0)
    assert _kernels.LAUNCHES == before


def test_flop_formula_counts_whole_chunks():
    c, dk = 64, 128
    per_chunk = (c * (c - 1) // 2 * dk + c * (c + 1) // 2 * dk + c * (c - 1) // 2 * 2 * dk
                 + 3 * c * dk * dk + c * (c + 1) // 2 * dk)
    assert kda.kda_flops(1, 32768, 32) == 2 * 32 * 512 * per_chunk
    assert kda.kda_flops(2, 65, 3) == 2 * 2 * 3 * 2 * per_chunk


def test_conv_is_causal():
    """The output at t is unchanged by any input after t."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 30, 3 * 2 * 16, generator=gen)
    w = torch.randn(3 * 2 * 16, 4, generator=gen)
    before = kda.conv_qkv_ops(x, w, 2, 16)
    x2 = x.clone()
    x2[:, 12:] = torch.randn(2, 18, 96, generator=gen)
    after = kda.conv_qkv_ops(x2, w, 2, 16)
    for a, b in zip(before, after):
        assert torch.equal(a[:, :12], b[:, :12])
        assert not torch.equal(a[:, 12:], b[:, 12:])


def test_conv_matches_the_reference_taps_and_norms_q_and_k():
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(1, 25, 3 * 2 * 16, generator=gen)
    w = torch.randn(3 * 2 * 16, 4, generator=gen)
    q, k, v = kda.conv_qkv(x, w, 2, 16)
    y = torch.nn.functional.silu(ref._causal_conv(x, w)).view(1, 25, 3, 2, 16)
    torch.testing.assert_close(v, y[:, :, 2], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(k, torch.nn.functional.normalize(y[:, :, 1], dim=-1, eps=0),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(q.pow(2).sum(-1), torch.ones(1, 25, 2), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------- model

def _weights(dtype=torch.float32, seed=5, **over):
    return kimi_linear_weights.weights(dict(TINY, **over), seed, "cpu", dtype=dtype)


def _model(weights, dtype=torch.float32, **over):
    model = KimiLinearLM(KimiLinearConfig.from_dict(dict(TINY, **over)), device="meta",
                         dtype=dtype)
    model.load_state_dict({k: v if k.endswith(kimi_linear_weights.FLOAT32) else v.to(dtype)
                           for k, v in weights.items()}, assign=True)
    return model


def _tokens(batch=2, seed=1):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, TINY["vocab_size"], (batch, SEQ), generator=gen)


def _rel(got, want):
    return float((got.float() - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt())


@pytest.fixture
def setting():
    weights, tokens = _weights(), _tokens()
    with torch.no_grad():
        want = ref.forward(weights, tokens, TINY)
    return weights, tokens, want


def test_config_reads_the_published_keys_and_layer_kinds():
    from evalbench import spec

    cfg = spec.cell("kimilinear48b_eval_32k").config
    c = KimiLinearConfig.from_dict(cfg)
    kinds = c.layer_kinds()
    assert kinds.count("kda") == 20 and kinds.count("mla") == 7
    assert [i + 1 for i, k in enumerate(kinds) if k == "mla"] == [4, 8, 12, 16, 20, 24, 27]
    assert (c.num_experts, c.router_width, tuple(c.held_expert_ids)) == (64, 256, tuple(range(64)))
    assert c.mla_use_nope and c.num_experts_per_token == 8 and c.hidden_size == 2304
    assert KimiLinearConfig().held_expert_ids is None
    for bad in ({"num_expert_group": 2}, {"moe_router_activation_func": "softmax"},
                {"q_lora_rank": 1536}, {"tie_word_embeddings": True}):
        with pytest.raises(ValueError):
            KimiLinearConfig.from_dict(dict(cfg, **bad))
    layers = dict(cfg["linear_attn_config"], kda_layers=[1, 2, 3])
    with pytest.raises(ValueError, match="neither"):
        KimiLinearConfig.from_dict(dict(cfg, linear_attn_config=layers))


def test_weights_are_named_and_shaped_as_the_program_at_full_width():
    from evalbench import spec

    cfg = spec.cell("kimilinear48b_eval_32k").config
    shapes = kimi_linear_weights.shapes(cfg)
    program = KimiLinearLM(KimiLinearConfig.from_dict(cfg), device="meta").named_parameters()
    assert shapes == {name: tuple(p.shape) for name, p in program}
    held = sum(torch.Size(s).numel() for s in shapes.values())
    whole = sum(torch.Size(s).numel() for s in kimi_linear_weights.shapes(
        dict(cfg, num_experts=256)).values())
    assert abs(held / 1.379e10 - 1) < 1e-3 and abs(whole / 4.912e10 - 1) < 1e-3


@pytest.mark.parametrize("batch", (1, 2))
def test_float32_forward_matches_the_reference(batch):
    weights, tokens = _weights(), _tokens(batch)
    with torch.no_grad():
        got = _model(weights)(tokens)
        want = ref.forward(weights, tokens, TINY)
    assert got.shape == (batch, SEQ, TINY["vocab_size"])
    assert _rel(got, want) < F32_TOL


def _no_l2(monkeypatch):
    monkeypatch.setattr(kda, "l2_normalize", lambda x: x)


def _no_decay(monkeypatch):
    real = model_module.kda_chunked
    monkeypatch.setattr(model_module, "kda_chunked",
                        lambda q, k, v, g, beta, scale: real(q, k, v, g * 0, beta, scale))


def _beta_one(monkeypatch):
    real = model_module.kda_chunked
    monkeypatch.setattr(model_module, "kda_chunked",
                        lambda q, k, v, g, beta, scale: real(q, k, v, g, beta * 0 + 1, scale))


@pytest.mark.parametrize("mutate", (_no_l2, _no_decay, _beta_one),
                         ids=("no_l2_norm", "no_decay", "beta_one"))
def test_each_mutation_fails_the_comparison(mutate, setting, monkeypatch):
    weights, tokens, want = setting
    mutate(monkeypatch)
    with torch.no_grad():
        got = _model(weights)(tokens)
    assert _rel(got, want) > 100 * F32_TOL


@pytest.mark.parametrize("over", (dict(held_expert_start=0), dict(mla_use_nope=False)),
                         ids=("other_held_experts", "rope_in_mla"))
def test_each_config_mutation_fails_the_comparison(over, setting):
    weights, tokens, want = setting
    with torch.no_grad():
        got = _model(weights, **over)(tokens)
    assert _rel(got, want) > 100 * F32_TOL


def test_forward_counts_routed_and_held_pairs():
    weights, tokens = _weights(), _tokens()
    model = _model(weights)
    before = moe.moe_counts()
    with torch.no_grad():
        model(tokens)
    after = moe.moe_counts()
    pairs = tokens.numel() * TINY["num_experts_per_token"] * 3
    held = after["held_pairs"] - before["held_pairs"]
    assert after["forwards"] - before["forwards"] == 1
    assert after["routed_pairs"] - before["routed_pairs"] == pairs
    assert 0 < held < pairs
    assert after["loaded_pairs"] - before["loaded_pairs"] == held


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_held_shares_with_the_shared_expert_once_add_up_to_the_whole_layer(seed):
    """Four chips' shares of an expert layer (2 of 8 experts each), each
    adding the shared expert, summed with the shared expert counted once,
    give the uncut layer; each share is its own reference's."""
    c = MLAMoEConfig(hidden_size=32, moe_intermediate_size=12, n_routed_experts=8,
                     n_shared_experts=1, num_experts_per_tok=3)
    gen = torch.Generator().manual_seed(seed)
    whole = MoE(c, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        for p in whole.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
        x = torch.randn(2, 20, 32, generator=gen)
        total = torch.zeros_like(x)
        for lo in (0, 2, 4, 6):
            part = MoE(c, device="cpu", dtype=torch.float32, expert_ids=range(lo, lo + 2))
            for name, p in part.named_parameters():
                full = getattr(whole, name)
                p.copy_(full[lo:lo + 2] if name in ("gate_up", "down") else full)
            got = part(x)
            want = moe.moe_topk_reference(
                x.reshape(-1, 32), part.router, part.bias, part.gate_up, part.down, k=3,
                routed_scaling_factor=c.routed_scaling_factor,
                expert_ids=torch.arange(lo, lo + 2),
                shared=(part.shared_gate_up, part.shared_down)).view(x.shape)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            total += got
        shared = moe.swiglu(x, whole.shared_gate_up, whole.shared_down)
        torch.testing.assert_close(total - 3 * shared, whole(x), rtol=1e-5, atol=1e-5)


def test_expert_ids_outside_the_router_are_refused():
    c = MLAMoEConfig(hidden_size=32, moe_intermediate_size=12, n_routed_experts=8)
    with pytest.raises(ValueError, match="outside"):
        MoE(c, device="meta", dtype=torch.float32, expert_ids=[6, 8])


def test_spans_open_per_kda_layer_with_the_recorder_on():
    from torch.profiler import ProfilerActivity, profile

    from torcheval_tpu_torch import obs

    model = _model(_weights())
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        obs.enable()
        try:
            model(_tokens(1))
        finally:
            obs.disable()
            obs.recorder().reset()
    names = [e.name for e in prof.events() if e.name.startswith("torcheval.")]
    assert names.count("torcheval.kda") == 3 and names.count("torcheval.kda.scan") == 3
    assert names.count("torcheval.mla") == 1
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        model(_tokens(1))
    assert not [e.name for e in prof.events() if e.name.startswith("torcheval.")]


def test_smoke_check_passes_the_op_sequence_on_cpu(monkeypatch):
    """``chip_smoke``'s check of the scan kernel, where the kernel is the
    op sequence: no error, no launch."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "_kda_kernel", kda.kda_ops)
    gen = torch.Generator().manual_seed(4)
    for shape, decay in (((1, 70, 2, 128), "cell"), ((2, 37, 1, 128), -20.0)):
        out = chip_smoke._kda_check(*chip_smoke._kda_inputs(gen, shape, decay, "cpu"), "cpu")
        assert out["rms_rel"] == 0 and out["finite"] and out["launches"] == 0


@pytest.mark.parametrize("fault", ("decays_ignored", "a_token_late"))
def test_smoke_check_catches_a_wrong_scan(fault, monkeypatch):
    import chip_smoke

    def wrong(q, k, v, g, beta, scale):
        if fault == "decays_ignored":
            return kda.kda_ops(q, k, v, torch.zeros_like(g), beta, scale)
        o = kda.kda_ops(q, k, v, g, beta, scale)
        return torch.cat([torch.zeros_like(o[:, :1]), o[:, :-1]], 1)

    monkeypatch.setattr(chip_smoke, "_kda_kernel", wrong)
    gen = torch.Generator().manual_seed(5)
    inputs = chip_smoke._kda_inputs(gen, (1, 200, 2, 128), -0.5, "cpu")
    with pytest.raises(AssertionError):
        chip_smoke._kda_check(*inputs, "cpu")


def test_smoke_conv_check_passes_the_op_sequence_and_catches_reversed_taps(monkeypatch):
    import chip_smoke

    gen = torch.Generator().manual_seed(6)
    x = (torch.randn(2, 37, 3 * 2 * 128, generator=gen) * 0.3).bfloat16()
    w = (torch.randn(3 * 2 * 128, 4, generator=gen) * 0.29).bfloat16()
    monkeypatch.setattr(chip_smoke, "_kda_conv_kernel",
                        lambda x, w, h: kda.conv_qkv_ops(x.float(), w.float(), h))
    out = chip_smoke._kda_conv_check(x, w, 2, "cpu")
    assert out["rms_rel"] == [0.0] * 3 and out["launches"] == 0
    assert all(0 < e <= chip_smoke.KDA_CONV_RMS_REL_LIMIT for e in out["plain_rms_rel"])
    monkeypatch.setattr(chip_smoke, "_kda_conv_kernel",
                        lambda x, w, h: kda.conv_qkv_ops(x.float(), w.float().flip(-1), h))
    with pytest.raises(AssertionError):
        chip_smoke._kda_conv_check(x, w, 2, "cpu")


# -------------------------------------------------------------------- card

def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: the KDA kernels have no CPU form")
    return torch.device("cuda", torch.cuda.current_device())


def _card_scan_inputs(dev, b, t, h, g_low, seed):
    q, k, v, g, beta = _scan_inputs(t=t, b=b, h=h, d=128, g_low=g_low, seed=seed)
    return (q.to(dev, torch.bfloat16), k.to(dev, torch.bfloat16), v.to(dev, torch.bfloat16),
            g.to(dev), beta.to(dev))


@pytest.mark.card
@pytest.mark.parametrize("b, t, h, g_low", ((2, 200, 3, -0.5), (1, 64, 1, -0.5),
                                            (1, 1000, 2, -20.0), (1, 4100, 4, -1.0)))
def test_kernel_matches_the_op_sequence(b, t, h, g_low):
    """bf16 operands of the kernel's products (the state and U rounded as
    they enter them) against the float32 op sequence: ~0.4-0.5 % RMS
    measured on an H100; 2 % bounds it."""
    dev = _card()
    q, k, v, g, beta = _card_scan_inputs(dev, b, t, h, g_low, seed=t)
    assert kda.takes(q, k, v, g, beta)
    before = _kernels.LAUNCHES["kda"]
    with torch.no_grad():
        got = kda.kda_chunked(q, k, v, g, beta, 128 ** -0.5)
        torch.cuda.synchronize()
        want = kda.kda_ops(q, k, v, g, beta, 128 ** -0.5)
    assert _kernels.LAUNCHES["kda"] - before == 2
    assert torch.isfinite(got).all()
    assert _rel(got, want.float()) < 0.02


@pytest.mark.card
def test_conv_kernel_matches_the_op_sequence():
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(5)
    x = (torch.randn(2, 301, 3 * 4 * 128, generator=gen, device=dev) * 0.3).bfloat16()
    w = (torch.randn(3 * 4 * 128, 4, generator=gen, device=dev) * 0.29).bfloat16()
    before = _kernels.LAUNCHES["kda_conv"]
    with torch.no_grad():
        got = kda.conv_qkv(x, w, 4)
        want = kda.conv_qkv_ops(x, w, 4)
    assert _kernels.LAUNCHES["kda_conv"] - before == 1
    for a, b in zip(got, want):
        assert a.is_contiguous() and a.shape == (2, 301, 4, 128)
        assert _rel(a, b.float()) < 1e-3


@pytest.mark.card
def test_forward_makes_no_host_sync_on_the_card():
    dev = _card()
    cfg = dict(TINY, linear_attn_config=dict(TINY["linear_attn_config"], head_dim=128))
    weights = kimi_linear_weights.weights(cfg, 5, dev)
    model = KimiLinearLM(KimiLinearConfig.from_dict(cfg), device="meta", dtype=torch.bfloat16)
    model.load_state_dict(weights, assign=True)
    tokens = _tokens().to(dev)
    before = _kernels.LAUNCHES["kda"]
    with torch.no_grad():
        want = model(tokens)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = model(tokens)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert torch.equal(got, want)
    assert _kernels.LAUNCHES["kda"] - before == 2 * 3 * 2

