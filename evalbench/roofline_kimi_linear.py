"""The work a Kimi Linear eval step needs (``loop`` ``kimi_linear_eval``),
counted from the configuration's sizes as ``roofline.py`` counts: 2 FLOPs
a multiply-add of the equations (``reference/kimi_linear.py``), each input
byte read once and each output byte written once.

The expert layer holds ``num_experts`` of ``router_experts`` experts: a
token's ``num_experts_per_token`` routed pairs land on the held ones
``num_experts / router_experts`` of the time on average, so a token counts
that share of its routed experts' products.
"""

from __future__ import annotations

from evalbench import roofline

CHUNK = 64


def _layers(c: dict):
    la = c["linear_attn_config"]
    kda = len(la["kda_layers"])
    return kda, c["num_hidden_layers"] - kda


def kda_layer_params(c: dict) -> int:
    """Weights a token multiplies through in one KDA layer: the q, k and v
    projections, the gates (f_a, g_a, beta), f_b, g_b and the output."""
    d, la = c["hidden_size"], c["linear_attn_config"]
    h, k = la["num_heads"], la["head_dim"]
    return d * 3 * h * k + d * (2 * k + h) + 2 * k * h * k + h * k * d


def matmul_params_per_token(c: dict) -> int:
    """Weights one token multiplies through: every KDA and MLA projection
    (the convolutions' taps counted as weights), the dense layers' SwiGLU,
    each MoE layer's router, the held share of its routed experts and the
    shared experts, and the head."""
    d, heads = c["hidden_size"], c["num_attention_heads"]
    nope, rope, dv = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    rank, f = c["kv_lora_rank"], c["moe_intermediate_size"]
    la = c["linear_attn_config"]
    kda_layers, mla_layers = _layers(c)
    conv = 3 * la["num_heads"] * la["head_dim"] * la["short_conv_kernel_size"]
    mla = d * heads * (nope + rope) + d * (rank + rope) + rank * heads * (nope + dv) + heads * dv * d
    router = c.get("router_experts") or c["num_experts"]
    routed = c["num_experts_per_token"] * 3 * d * f * c["num_experts"] // router
    moe = d * router + routed + 3 * d * f * c["num_shared_experts"]
    dense_layers = c["first_k_dense_replace"]
    moe_layers = c["num_hidden_layers"] - dense_layers
    return (kda_layers * (kda_layer_params(c) + conv) + mla_layers * mla
            + dense_layers * 3 * d * c["intermediate_size"] + moe_layers * moe
            + d * c["vocab_size"])


def kda_scan_flops(c: dict, seq: int, batch: int = 1) -> int:
    """FLOPs of one layer's chunked scan over ``batch`` windows of ``seq``
    tokens (chunks of 64, whole chunks counted): per chunk and head, A and
    M over the C(C-1)/2 and C(C+1)/2 pairs of d_k, the triangular solve
    over C(C-1)/2 pairs of d_k + d_v, U = W_v - W_k S and the state update
    (C d_k d_v each), O = Q S (C d_k d_v) + M U (C(C+1)/2 d_v)."""
    la = c["linear_attn_config"]
    h, dk = la["num_heads"], la["head_dim"]
    dv = dk
    tri, tri_in = CHUNK * (CHUNK - 1) // 2, CHUNK * (CHUNK + 1) // 2
    macs = tri * dk + tri_in * dk + tri * (dk + dv) + 3 * CHUNK * dk * dv + tri_in * dv
    return 2 * batch * h * (-(-seq // CHUNK)) * macs


def kda_scan_bytes(c: dict, seq: int, batch: int = 1) -> int:
    """Bytes of one layer's scan: q, k and v read (bf16), g read (float32,
    d_k a head), beta read (float32, one a head), o written (bf16)."""
    la = c["linear_attn_config"]
    h, dk = la["num_heads"], la["head_dim"]
    dv = dk
    return batch * seq * h * (2 * dk + 2 * dk + 2 * dv + 4 * dk + 4 + 2 * dv)


def kda_scan_least_s(c: dict, seq: int, batch: int = 1) -> float:
    """The least time the card could take for one layer's scan: the larger
    of its FLOPs at the bf16 peak and its bytes at the HBM peak."""
    return max(kda_scan_flops(c, seq, batch) / roofline.BF16_PEAK_FLOPS,
               kda_scan_bytes(c, seq, batch) / roofline.HBM_BYTES_PER_S)


def held_expert_flops(c: dict, pairs: int) -> int:
    """The held experts' grouped products over ``pairs`` routed pairs (a
    token and a held expert each): three d x f products a pair."""
    return 2 * pairs * 3 * c["hidden_size"] * c["moe_intermediate_size"]


def held_expert_bytes(c: dict, pairs: int, steps: int, weight_bytes: int = 2,
                      act_bytes: int = 2) -> int:
    """The held experts' bytes over ``steps`` steps holding ``pairs``
    routed pairs in all: each held expert's three kernels read once a MoE
    layer a step, and each pair's token read in and its output written."""
    moe_layers = c["num_hidden_layers"] - c["first_k_dense_replace"]
    d, f = c["hidden_size"], c["moe_intermediate_size"]
    weights = steps * moe_layers * c["num_experts"] * 3 * d * f * weight_bytes
    return weights + pairs * 2 * d * act_bytes


def held_expert_least_s(c: dict, pairs: int, steps: int) -> float:
    """The least time the card could take for the held experts' work over
    ``steps`` steps of ``pairs`` held pairs in all: the larger of its
    FLOPs at the bf16 peak and its bytes at the HBM peak."""
    return max(held_expert_flops(c, pairs) / roofline.BF16_PEAK_FLOPS,
               held_expert_bytes(c, pairs, steps) / roofline.HBM_BYTES_PER_S)


def forward_flops(c: dict, seq: int, batch: int = 1) -> int:
    """FLOPs of one forward over ``batch`` windows of ``seq`` tokens: 2 a
    weight a token (``matmul_params_per_token``), every KDA layer's scan,
    and each MLA layer's causal products, QK^T over the nope + rope dims
    and PV over the value dims, each over S^2 / 2 pairs a head."""
    kda_layers, mla_layers = _layers(c)
    heads = c["num_attention_heads"]
    qk, dv = c["qk_nope_head_dim"] + c["qk_rope_head_dim"], c["v_head_dim"]
    attention = mla_layers * batch * seq * seq * heads * (qk + dv)
    return (2 * batch * seq * matmul_params_per_token(c) + attention
            + kda_layers * kda_scan_flops(c, seq, batch))
