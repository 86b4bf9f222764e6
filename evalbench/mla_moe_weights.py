"""The weights of an MLA + MoE configuration (``loop`` ``mla_moe_eval``),
drawn from the run's seed.

The names and shapes are those of the program's
``torcheval_tpu_torch.models.MLAMoELM`` with every routed expert held,
written out here so the reference and the control can draw the weights
without loading the program: ``(in, out)`` kernels, the experts stacked
``(experts, in, out)`` with gate and up side by side (gate first), the
shared experts as one SwiGLU of their summed width. The loop and the
reference both read :func:`weights`.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from evalbench.traffic import generator

# each drawn tensor starts on a multiple of this many elements of the flat
# buffer (256 bytes in bfloat16): the grouped products want aligned bases
ALIGN = 128


def shapes(config: dict) -> Dict[str, Tuple[int, ...]]:
    """Parameter name -> shape at ``config``'s widths, in the program's
    order."""
    d, h, v = config["hidden_size"], config["num_attention_heads"], config["vocab_size"]
    nope, rope, dv = config["qk_nope_head_dim"], config["qk_rope_head_dim"], config["v_head_dim"]
    rank, e, f = config["kv_lora_rank"], config["n_routed_experts"], config["moe_intermediate_size"]
    fs = f * config["n_shared_experts"]
    out: Dict[str, Tuple[int, ...]] = {"embed": (v, d)}
    for i in range(config["num_hidden_layers"]):
        p = f"layers.{i}."
        out[p + "attn_norm"] = (d,)
        out[p + "attn.q"] = (d, h * (nope + rope))
        out[p + "attn.kv_a"] = (d, rank + rope)
        out[p + "attn.kv_a_norm"] = (rank,)
        out[p + "attn.kv_b"] = (rank, h * (nope + dv))
        out[p + "attn.o"] = (h * dv, d)
        out[p + "mlp_norm"] = (d,)
        if i < config["first_k_dense_replace"]:
            out[p + "mlp.gate_up"] = (d, 2 * config["intermediate_size"])
            out[p + "mlp.down"] = (config["intermediate_size"], d)
        else:
            out[p + "moe.router"] = (e, d)
            out[p + "moe.bias"] = (e,)
            out[p + "moe.gate_up"] = (e, d, 2 * f)
            out[p + "moe.down"] = (e, f, d)
            out[p + "moe.shared_gate_up"] = (d, 2 * fs)
            out[p + "moe.shared_down"] = (fs, d)
    out["norm"] = (d,)
    out["head"] = (d, v)
    return out


def _std(name: str, config: dict) -> float:
    """N(0, ``init_std``) for every matrix and the embedding
    (DeepSeek-V3's ``initializer_range``), N(0,
    ``e_score_correction_bias_std``) for each router's correction bias."""
    if name.endswith(".bias"):
        return float(config["e_score_correction_bias_std"])
    return float(config["init_std"])


def weights(config: dict, seed: int, device, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Random weights for ``config`` from ``seed``: every drawn tensor
    from one ``randn`` over one flat ``dtype`` buffer, scaled in place
    slice by slice (each slice starting on an ``ALIGN`` boundary); RMSNorm
    scales 1. The drawn tensors are views of that buffer."""
    all_shapes = shapes(config)
    drawn = [k for k in all_shapes if not k.endswith("norm")]
    starts, at = {}, 0
    for k in drawn:
        starts[k] = at
        at += -(-math.prod(all_shapes[k]) // ALIGN) * ALIGN
    flat = torch.randn(at, generator=generator(seed, device, stream=2), device=device, dtype=dtype)
    out = {}
    for k, shape in all_shapes.items():
        if k in starts:
            out[k] = flat[starts[k]:starts[k] + math.prod(shape)].view(shape).mul_(_std(k, config))
        else:
            out[k] = torch.ones(shape, device=device, dtype=dtype)
    return out
