"""The work an MLA + MoE eval step needs (``loop`` ``mla_moe_eval``),
counted from the configuration's sizes as ``roofline.py`` counts: 2 FLOPs
a multiply-add of the equations (``reference/mla_moe.py``), each input
byte read once and each output byte written once.
"""

from __future__ import annotations

from evalbench import roofline


def matmul_params_per_token(c: dict) -> int:
    """Weights one token multiplies through: every projection of MLA, the
    dense layers' SwiGLU, each MoE layer's router, ``num_experts_per_tok``
    routed experts and the shared experts, and the head."""
    d, h = c["hidden_size"], c["num_attention_heads"]
    nope, rope, dv = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    rank, f = c["kv_lora_rank"], c["moe_intermediate_size"]
    attention = d * h * (nope + rope) + d * (rank + rope) + rank * h * (nope + dv) + h * dv * d
    dense = 3 * d * c["intermediate_size"]
    moe = (d * c["n_routed_experts"] + c["num_experts_per_tok"] * 3 * d * f
           + 3 * d * f * c["n_shared_experts"])
    dense_layers = c["first_k_dense_replace"]
    moe_layers = c["num_hidden_layers"] - dense_layers
    return c["num_hidden_layers"] * attention + dense_layers * dense + moe_layers * moe \
        + d * c["vocab_size"]


def forward_flops(c: dict, seq: int, batch: int = 1) -> int:
    """FLOPs of one forward over ``batch`` windows of ``seq`` tokens: 2 a
    weight a token, and causal attention's two products, QK^T over the
    nope + rope dims and PV over the value dims, each over S^2 / 2 pairs a
    head a layer."""
    h = c["num_attention_heads"]
    qk, dv = c["qk_nope_head_dim"] + c["qk_rope_head_dim"], c["v_head_dim"]
    attention = c["num_hidden_layers"] * batch * seq * seq * h * (qk + dv)
    return 2 * batch * seq * matmul_params_per_token(c) + attention


def expert_flops(c: dict, tokens: int) -> int:
    """The routed experts' grouped products over ``tokens`` tokens: k
    SwiGLU experts a token (three d x f products), every MoE layer."""
    moe_layers = c["num_hidden_layers"] - c["first_k_dense_replace"]
    d, f = c["hidden_size"], c["moe_intermediate_size"]
    return 2 * tokens * c["num_experts_per_tok"] * 3 * d * f * moe_layers


def expert_bytes(c: dict, tokens: int, weight_bytes: int = 2, act_bytes: int = 2) -> int:
    """The routed experts' bytes over ``tokens`` tokens, every MoE layer:
    each expert's three kernels read once, and each routed pair's token
    read in and its output written."""
    moe_layers = c["num_hidden_layers"] - c["first_k_dense_replace"]
    d, f = c["hidden_size"], c["moe_intermediate_size"]
    weights = c["n_routed_experts"] * 3 * d * f * weight_bytes
    pairs = tokens * c["num_experts_per_tok"] * 2 * d * act_bytes
    return moe_layers * (weights + pairs)


def expert_least_s(c: dict, tokens: int) -> float:
    """The least time the card could take for the routed experts' work:
    the larger of their FLOPs at the bf16 peak and their bytes at the HBM
    peak."""
    return max(expert_flops(c, tokens) / roofline.BF16_PEAK_FLOPS,
               expert_bytes(c, tokens) / roofline.HBM_BYTES_PER_S)
