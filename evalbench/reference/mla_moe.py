"""A float32 copy of the DeepSeek-V3-family forward equations (MLA and a
top-k mixture of experts), and its float8 control.

The equations are DeepSeek-V3's (arXiv:2412.19437; the ``config.json`` of
moonshotai/Moonlight-16B-A3B, ``model_type`` ``deepseek_v3``) without
q-LoRA, with one expert group (``n_group`` = ``topk_group`` = 1) and the
sizes as the configuration file gives them. With d the hidden size, H
heads, n / r / v the nope, rope and value head sizes, tokens t of one
window of S:

    x = E[t]
    per layer:  h = RMSNorm(x)
                q = h Wq, split per head into q_n (n) and q_r (r)
                [c, k_r] = h Wkv_a;  [k_n, v] = RMSNorm(c) Wkv_b per head
                q_r, k_r = RoPE(q_r), RoPE(k_r)  (k_r shared by the heads)
                a = softmax([q_n, q_r] . [k_n, k_r] / sqrt(n + r) + causal mask) v
                x = x + a Wo
                h = RMSNorm(x)
                dense layers (the first first_k_dense_replace):
                    x = x + SwiGLU(h)
                MoE layers:
                    s = sigmoid(h Wr^T)                  (float32)
                    K = top-k experts of s + b           (b: the correction bias)
                    g_e = s_e / sum_{K} s  (norm_topk_prob), times routed_scaling_factor
                    x = x + sum_{e in K} g_e SwiGLU_e(h) + SwiGLU_shared(h)
    logits = RMSNorm(x) Wout

with SwiGLU(h) = (silu(h W_gate) * h W_up) W_down, RMSNorm(y) = y /
sqrt(mean(y^2) + eps) * scale, and RoPE turning each adjacent pair (2i,
2i+1) by pos * theta^(-2i / r) (DeepSeek-V3's ``view_as_complex`` order).

Departures from the published model, each also in the configuration's
``assumed``: random weights from the seed (every matrix N(0, ``init_std``),
the correction bias N(0, ``e_score_correction_bias_std``) where a trained
model learns it, RMSNorm scales 1); the ``n_shared_experts`` shared experts
as one SwiGLU of their summed width, as DeepSeek-V3's code builds them.

It is computed plainly: float32 with TF32 off, attention over query
blocks of ``BLOCK`` rows (each against the keys it may see), each expert
applied in a loop to the rows its own float32 scores routed to it
(``nonzero``), each expert's weights read from the bfloat16 dict and
widened one expert at a time. The weights come as a dict named as the
program's parameters are (``evalbench/mla_moe_weights.py``); they are read,
never changed. ``forward(..., fp8_control=True)`` is the control: the same
equations in bfloat16 with both operands of every product (the router's
too) rounded to float8 e4m3 under a per-tensor scale, and the logits
returned as float8 values, the step below the configuration's bfloat16.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from evalbench.reference.gpt2 import _prec, fp8

BLOCK = 1024


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    a, b = xf[..., 0::2], xf[..., 1::2]
    return torch.stack((a * cos - b * sin, a * sin + b * cos), dim=-1).flatten(-2).to(x.dtype)


def forward(weights: Dict[str, torch.Tensor], tokens: torch.Tensor, config: dict,
            fp8_control: bool = False) -> torch.Tensor:
    """Logits (B, S, V) of ``tokens`` (B, S): float32, or with
    ``fp8_control`` bfloat16 holding float8 values."""
    _prec()
    dt = torch.bfloat16 if fp8_control else torch.float32
    q8 = fp8 if fp8_control else (lambda t: t)
    c = config
    d, heads = c["hidden_size"], c["num_attention_heads"]
    nope, rope, dv = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    rank, k = c["kv_lora_rank"], c["num_experts_per_tok"]
    eps = float(c["rms_norm_eps"])
    w = lambda name: weights[name].to(dt)  # noqa: E731

    def mm(a, b):
        return q8(a) @ q8(b)

    def norm(y, name):
        yf = y.float()
        return (yf * torch.rsqrt(yf.pow(2).mean(-1, keepdim=True) + eps)).to(dt) * w(name)

    def swiglu(y, gate_up, down):
        g = mm(y, gate_up)
        return mm(F.silu(g[..., : down.shape[0]]) * g[..., down.shape[0]:], down)

    b, s = tokens.shape
    dev = tokens.device
    pairs = torch.arange(0, rope, 2, device=dev, dtype=torch.float32)
    inv = 1.0 / float(c["rope_theta"]) ** (pairs / rope)
    ang = torch.arange(s, device=dev, dtype=torch.float32)[:, None] * inv[None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    keys = torch.arange(s, device=dev)
    x = weights["embed"][tokens].to(dt)
    for i in range(c["num_hidden_layers"]):
        p = f"layers.{i}."
        h = norm(x, p + "attn_norm")
        q = mm(h, w(p + "attn.q")).view(b, s, heads, nope + rope)
        q = torch.cat([q[..., :nope], _rope(q[..., nope:], cos[:, None], sin[:, None])], -1)
        kv_a = mm(h, w(p + "attn.kv_a"))
        kv = mm(norm(kv_a[..., :rank], p + "attn.kv_a_norm"), w(p + "attn.kv_b"))
        kv = kv.view(b, s, heads, nope + dv)
        k_r = _rope(kv_a[..., rank:], cos, sin)[:, :, None, :].expand(b, s, heads, rope)
        key = torch.cat([kv[..., :nope], k_r], -1)
        v = kv[..., nope:]
        a = torch.empty(b, s, heads, dv, dtype=dt, device=dev)
        for lo in range(0, s, BLOCK):
            hi = min(lo + BLOCK, s)
            scores = torch.einsum("bqhd,bkhd->bhqk", q8(q[:, lo:hi]), q8(key[:, :hi]))
            scores = scores.float() / math.sqrt(nope + rope)
            mask = keys[None, :hi] <= keys[lo:hi, None]
            probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1).to(dt)
            a[:, lo:hi] = torch.einsum("bhqk,bkhd->bqhd", q8(probs), q8(v[:, :hi]))
            del scores, probs
        x = x + mm(a.reshape(b, s, heads * dv), w(p + "attn.o"))
        h = norm(x, p + "mlp_norm")
        if i < c["first_k_dense_replace"]:
            x = x + swiglu(h, w(p + "mlp.gate_up"), w(p + "mlp.down"))
            continue
        flat = h.reshape(b * s, d)
        scores = torch.sigmoid(mm(flat, w(p + "moe.router").t()).float())
        choice = torch.topk(scores + weights[p + "moe.bias"].float(), k, dim=-1).indices
        gate = scores.gather(1, choice)
        if c["norm_topk_prob"]:
            gate = gate / (gate.sum(-1, keepdim=True) + 1e-20)
        gate = gate * float(c["routed_scaling_factor"])
        routed = torch.zeros(b * s, d, dtype=torch.float32, device=dev)
        for e in range(c["n_routed_experts"]):
            tok, slot = torch.nonzero(choice == e, as_tuple=True)
            if tok.numel():
                y = swiglu(flat[tok], weights[p + "moe.gate_up"][e].to(dt),
                           weights[p + "moe.down"][e].to(dt))
                routed.index_add_(0, tok, y.float() * gate[tok, slot, None])
        shared = swiglu(flat, w(p + "moe.shared_gate_up"), w(p + "moe.shared_down"))
        x = x + (routed.to(dt) + shared).view(b, s, d)
    return q8(mm(norm(x, "norm"), w("head")))
