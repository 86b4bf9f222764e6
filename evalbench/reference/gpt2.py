"""A frozen float32 copy of the GPT-2-width forward equations, and its
float8 control.

The equations are GPT-2's (Radford et al. 2019; the ``config.json`` of
openai-community/gpt2-xl) with the departures the configuration file lists
under ``assumed``: no biases on the projections, LayerNorm epsilon
``layer_norm_epsilon`` as run, an untied output head. With d = n_embd,
H = n_head heads of d / H, tokens t of one window of S:

    x = E[t] + P[0..S)
    per layer:  h = LN(x);  q, k, v = h Wq, h Wk, h Wv  (split into H heads)
                a = softmax(q k^T / sqrt(d / H) + causal mask) v
                x = x + a Wo
                x = x + gelu_tanh(LN(x) W1) W2
    logits = LN(x) Wout

The weights come as a dict named as the program's parameters are (the
layout the configuration fixes: q/k/v (d, H, d/H), out (H, d/H, d), dense
(in, out)); they are read, never changed. ``forward`` computes in float32
with TF32 off. ``forward(..., fp8=True)`` is the control: the same
equations in bfloat16 with both operands of every product rounded to
float8 e4m3 under a per-tensor scale (amax / 448), and the logits returned
as float8 values, the step below the configuration's bfloat16.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, back in
    ``x``'s dtype."""
    scale = x.abs().amax().float().clamp(min=1e-30) / E4M3_MAX
    return ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)


def _prec():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def forward(weights: Dict[str, torch.Tensor], tokens: torch.Tensor, config: dict,
            fp8_control: bool = False) -> torch.Tensor:
    """Logits (B, S, V) of ``tokens`` (B, S): float32, or with
    ``fp8_control`` bfloat16 holding float8 values."""
    _prec()
    dt = torch.bfloat16 if fp8_control else torch.float32
    q8 = fp8 if fp8_control else (lambda t: t)
    d, heads = config["n_embd"], config["n_head"]
    hd = d // heads
    eps = float(config["layer_norm_epsilon"])
    w = lambda name: weights[name].to(dt)  # noqa: E731

    def mm(a, b):
        return q8(a) @ q8(b)

    def ln(x, prefix):
        return F.layer_norm(x, (d,), w(prefix + ".scale"), w(prefix + ".bias"), eps)

    b, s = tokens.shape
    x = w("Embed_0.embedding")[tokens] + w("Embed_1.embedding")[:s][None]
    mask = torch.ones(s, s, dtype=torch.bool, device=tokens.device).tril()
    for i in range(config["n_layer"]):
        p = f"Block_{i}."
        h = ln(x, p + "LayerNorm_0")
        q, k, v = (mm(h, w(p + f"SelfAttention_0.{n}.kernel").reshape(d, d)).view(b, s, heads, hd)
                   .transpose(1, 2) for n in ("query", "key", "value"))
        scores = mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
        probs = torch.softmax(scores.float().masked_fill(~mask, float("-inf")), dim=-1).to(dt)
        del scores
        a = mm(probs, v).transpose(1, 2).reshape(b, s, d)
        del probs
        x = x + mm(a, w(p + "SelfAttention_0.out.kernel").reshape(d, d))
        h = F.gelu(mm(ln(x, p + "LayerNorm_1"), w(p + "Dense_0.kernel")), approximate="tanh")
        x = x + mm(h, w(p + "Dense_1.kernel"))
    logits = mm(ln(x, "LayerNorm_0"), w("Dense_0.kernel"))
    return q8(logits)
