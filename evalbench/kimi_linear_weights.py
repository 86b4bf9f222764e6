"""The weights of a Kimi Linear configuration (``loop``
``kimi_linear_eval``), drawn from the run's seed.

The names and shapes are those of the program's
``torcheval_tpu_torch.models.KimiLinearLM``, written out here so the
reference and the control can draw the weights without loading the
program: ``(in, out)`` kernels; a KDA layer's q, k and v projections side
by side (``attn.qkv``), their depthwise convolution kernels stacked
(``attn.conv``, (3 H d, w)), and the decay's and output gate's first
factors and the beta projection side by side (``attn.gates``: f_a | g_a |
b); an MLA layer as ``mla_moe_weights`` names it; the experts held here
stacked ``(held, in, out)`` with gate and up side by side (gate first),
the router over every expert. The loop and the reference both read
:func:`weights`.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from evalbench.traffic import generator

# each drawn tensor starts on a multiple of this many elements of the flat
# buffer (256 bytes in bfloat16): the grouped products want aligned bases
ALIGN = 128
FLOAT32 = ("attn.A_log", "attn.dt_bias")


def layer_kinds(config: dict) -> List[str]:
    """``"kda"`` or ``"mla"`` for each layer (1-indexed lists of
    ``linear_attn_config``)."""
    kda = set(config["linear_attn_config"]["kda_layers"])
    return ["kda" if i + 1 in kda else "mla" for i in range(config["num_hidden_layers"])]


def held(config: dict) -> int:
    return int(config["num_experts"])


def router_width(config: dict) -> int:
    return int(config.get("router_experts") or config["num_experts"])


def shapes(config: dict) -> Dict[str, Tuple[int, ...]]:
    """Parameter name -> shape at ``config``'s widths."""
    d, heads, v = config["hidden_size"], config["num_attention_heads"], config["vocab_size"]
    nope, rope, dv = config["qk_nope_head_dim"], config["qk_rope_head_dim"], config["v_head_dim"]
    rank, f = config["kv_lora_rank"], config["moe_intermediate_size"]
    la = config["linear_attn_config"]
    h, k, w = la["num_heads"], la["head_dim"], la["short_conv_kernel_size"]
    fs = f * config["num_shared_experts"]
    out: Dict[str, Tuple[int, ...]] = {"embed": (v, d)}
    for i, kind in enumerate(layer_kinds(config)):
        p = f"layers.{i}."
        out[p + "attn_norm"] = (d,)
        if kind == "kda":
            out[p + "attn.qkv"] = (d, 3 * h * k)
            out[p + "attn.conv"] = (3 * h * k, w)
            out[p + "attn.gates"] = (d, 2 * k + h)
            out[p + "attn.f_b"] = (k, h * k)
            out[p + "attn.dt_bias"] = (h * k,)
            out[p + "attn.A_log"] = (h,)
            out[p + "attn.g_b"] = (k, h * k)
            out[p + "attn.o_norm"] = (k,)
            out[p + "attn.o"] = (h * k, d)
        else:
            out[p + "attn.q"] = (d, heads * (nope + rope))
            out[p + "attn.kv_a"] = (d, rank + rope)
            out[p + "attn.kv_a_norm"] = (rank,)
            out[p + "attn.kv_b"] = (rank, heads * (nope + dv))
            out[p + "attn.o"] = (heads * dv, d)
        out[p + "mlp_norm"] = (d,)
        if i < config["first_k_dense_replace"]:
            out[p + "mlp.gate_up"] = (d, 2 * config["intermediate_size"])
            out[p + "mlp.down"] = (config["intermediate_size"], d)
        else:
            out[p + "moe.router"] = (router_width(config), d)
            out[p + "moe.bias"] = (router_width(config),)
            out[p + "moe.gate_up"] = (held(config), d, 2 * f)
            out[p + "moe.down"] = (held(config), f, d)
            out[p + "moe.shared_gate_up"] = (d, 2 * fs)
            out[p + "moe.shared_down"] = (fs, d)
    out["norm"] = (d,)
    out["head"] = (d, v)
    return out


def _std(name: str, config: dict) -> float:
    """N(0, ``init_std``) for every matrix and the embedding, N(0,
    ``conv_init_std``) for the convolution kernels, N(0,
    ``e_score_correction_bias_std``) for each router's correction bias."""
    if name.endswith(".bias"):
        return float(config["e_score_correction_bias_std"])
    if name.endswith(".conv"):
        return float(config["conv_init_std"])
    return float(config["init_std"])


def _gate_params(shape: Tuple[int, ...], name: str, g: torch.Generator, device) -> torch.Tensor:
    """float32 ``A_log = log(U(1, 16))`` a head, and ``dt_bias`` the
    inverse softplus of ``dt = exp(U(log 0.001, log 0.1))`` (at least
    1e-4) a channel: the initialisation of the Kimi Linear and Mamba
    code."""
    u = torch.rand(shape, generator=g, device=device, dtype=torch.float32)
    if name.endswith("A_log"):
        return torch.log(1.0 + 15.0 * u)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001)).clamp(min=1e-4)
    return dt + torch.log(-torch.expm1(-dt))


def weights(config: dict, seed: int, device, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Random weights for ``config`` from ``seed``: every drawn matrix from
    one ``randn`` over one flat ``dtype`` buffer, scaled in place slice by
    slice (each slice starting on an ``ALIGN`` boundary); the decay's
    ``A_log`` and ``dt_bias`` in float32 from a draw of their own; norm
    scales 1. The drawn matrices are views of that buffer."""
    all_shapes = shapes(config)
    drawn = [n for n in all_shapes if not n.endswith("norm") and not n.endswith(FLOAT32)]
    starts, at = {}, 0
    for n in drawn:
        starts[n] = at
        at += -(-math.prod(all_shapes[n]) // ALIGN) * ALIGN
    flat = torch.randn(at, generator=generator(seed, device, stream=2), device=device, dtype=dtype)
    gates = generator(seed, device, stream=4)
    out = {}
    for n, shape in all_shapes.items():
        if n in starts:
            out[n] = flat[starts[n]:starts[n] + math.prod(shape)].view(shape).mul_(_std(n, config))
        elif n.endswith(FLOAT32):
            out[n] = _gate_params(shape, n, gates, device)
        else:
            out[n] = torch.ones(shape, device=device, dtype=dtype)
    return out
