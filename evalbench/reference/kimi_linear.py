"""A float32 copy of the Kimi Linear forward equations (Kimi Delta
Attention, NoPE MLA, a top-k mixture of experts over the experts held
here), its float8 control, and the comparison of a step's logits with it
in blocks of rows.

The equations are the Kimi Linear report's (arXiv:2510.26692) and its
released ``config.json`` (moonshotai/Kimi-Linear-48B-A3B-Instruct,
``model_type`` ``kimi_linear``), with the sizes as the configuration file
gives them. With d the hidden size, tokens t of one window of S:

    x = E[t]
    per layer:  h = RMSNorm(x)
                KDA layers (linear_attn_config["kda_layers"], 1-indexed;
                H heads of K = head_dim):
                    q, k, v = SiLU(conv_w(h Wq)), SiLU(conv_w(h Wk)), SiLU(conv_w(h Wv))
                        (causal depthwise, kernel w = short_conv_kernel_size)
                    q, k = q / sqrt(|q|^2 + 1e-6), k / sqrt(|k|^2 + 1e-6)  (a head)
                    g = -exp(A_log) softplus(h Wf_a Wf_b + dt_bias)   (float32)
                    beta = sigmoid(h Wb)
                    token by token, a head, S_0 = 0:
                        S_t = (I - beta_t k_t k_t^T) Diag(exp g_t) S_{t-1} + beta_t k_t v_t^T
                        o_t = S_t^T q_t / sqrt(K)
                    x = x + (RMSNorm_head(o) * w_o * sigmoid(h Wg_a Wg_b)) Wo
                MLA layers (full_attn_layers), mla_use_nope:
                    q = h Wq;  [c, k_r] = h Wkv_a;  [k_n, v] = RMSNorm(c) Wkv_b a head
                    a = softmax([q_n, q_r] . [k_n, k_r] / sqrt(n + r) + causal mask) v
                        (no rotation: q_r and the shared k_r as projected)
                    x = x + a Wo
                h = RMSNorm(x)
                dense layers (the first first_k_dense_replace): x = x + SwiGLU(h)
                MoE layers: s = sigmoid(h Wr^T) over all router_experts (float32)
                    K = top-k of s + b (b: the correction bias)
                    g_e = s_e / sum_K s (moe_renormalize), times routed_scaling_factor
                    x = x + sum_{e in K, held} g_e SwiGLU_e(h) + SwiGLU_shared(h)
    logits = RMSNorm(x) Wout

with SwiGLU(h) = (silu(h W_gate) * h W_up) W_down and RMSNorm(y) = y /
sqrt(mean(y^2) + eps) * scale.

Departures from the published model, each also in the configuration's
``assumed``: random weights from the seed (``evalbench/kimi_linear_weights.py``);
the experts held here alone (``num_experts`` of ``router_experts``, ids
``held_expert_start`` on; the deployment's other chips would add the
rest, so each MoE layer's routed part is this chip's share); the
convolutions without bias; NoPE MLA keeping the rope dims of q and the
shared k_r unrotated; the correction bias drawn where a trained model
learns it.

It is computed plainly: float32 with TF32 off; KDA as the token-by-token
recurrence above (no chunks); attention over query blocks of ``BLOCK``
rows, each against the keys it may see; each held expert applied in a
loop to the rows its own float32 scores routed to it (``nonzero``); the
logits of a step made ``ROWS`` rows at a time (``step_readings``). The
weights come as a dict named as the program's parameters are; they are
read, never changed. ``fp8_control=True`` is the control: the same
equations in bfloat16 with both operands of every projection and of
attention's products (the router's too) rounded to float8 e4m3 under a
per-tensor scale, the scan's q, k and v rounded to float8 (its decays,
beta and state kept in float32, as the program keeps them: a bfloat16
decay would round exp(g) ~ 0.999 to 1 or 0.996 and change what the layer
remembers, not how precisely), and the logits returned as float8 values
(a scale a block of rows), the step below the configuration's bfloat16.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from evalbench.reference import compare
from evalbench.reference.gpt2 import _prec, fp8

BLOCK = 512
ROWS = 1024
L2_EPS = 1e-6


def kda_recurrence(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                   beta: torch.Tensor, scale: float) -> torch.Tensor:
    """The gated delta rule token by token, in q's dtype: q, k (B, T, H,
    K), v (B, T, H, V), g (B, T, H, K) log decays, beta (B, T, H); returns
    o (B, T, H, V)."""
    b, t, h, dk = q.shape
    dv = v.shape[-1]
    dt = q.dtype

    def heads(x):  # (B, T, H, D) -> (B H, T, D)
        return x.to(dt).permute(0, 2, 1, 3).reshape(b * h, t, -1)

    qh, kh, vh, decay = heads(q * scale), heads(k), heads(v), heads(torch.exp(g.float()))
    bh = beta.to(dt).permute(0, 2, 1).reshape(b * h, t, 1)
    bk, bv = kh * bh, vh * bh
    S = torch.zeros(b * h, dk, dv, dtype=dt, device=q.device)
    outs = []
    for i in range(t):
        # S <- Diag(exp g) S;  u = beta (v - S^T k);  S <- S + k u^T;  o = S^T q
        S.mul_(decay[:, i, :, None])
        u = torch.baddbmm(bv[:, i:i + 1], bk[:, i:i + 1], S, alpha=-1)
        S.baddbmm_(kh[:, i:i + 1].transpose(1, 2), u)
        outs.append(torch.bmm(qh[:, i:i + 1], S))
    o = torch.cat(outs, 1)  # (B H, T, V)
    return o.reshape(b, h, t, dv).permute(0, 2, 1, 3)


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y_t = sum_j w[:, j] x_{t - (W - 1) + j}, zero before the window."""
    width = w.shape[-1]
    s = x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    y = xp[:, 0:s] * w[:, 0]
    for j in range(1, width):
        y = y + xp[:, j:j + s] * w[:, j]
    return y


def hidden(weights: Dict[str, torch.Tensor], tokens: torch.Tensor, config: dict,
           fp8_control: bool = False, loads: Optional[List[torch.Tensor]] = None
           ) -> torch.Tensor:
    """The final RMSNorm's output (B, S, d), before the head: float32, or
    with ``fp8_control`` bfloat16. A list ``loads`` gains, for each MoE
    layer in order, the pairs its routing sent to each held expert (int64,
    ``num_experts`` entries)."""
    _prec()
    dt = torch.bfloat16 if fp8_control else torch.float32
    q8 = fp8 if fp8_control else (lambda t: t)
    c = config
    d, heads = c["hidden_size"], c["num_attention_heads"]
    nope, rope, dv = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    rank, topk = c["kv_lora_rank"], c["num_experts_per_token"]
    la = c["linear_attn_config"]
    h, hd = la["num_heads"], la["head_dim"]
    kda_layers = set(la["kda_layers"])
    held = int(c["num_experts"])
    start = int(c.get("held_expert_start", 0))
    eps = float(c["rms_norm_eps"])
    w = lambda name: weights[name].to(dt)  # noqa: E731

    def mm(a, b):
        return q8(a) @ q8(b)

    def norm(y, scale, eps=eps):
        yf = y.float()
        return (yf * torch.rsqrt(yf.pow(2).mean(-1, keepdim=True) + eps)).to(dt) * scale

    def swiglu(y, gate_up, down):
        gu = mm(y, gate_up)
        return mm(F.silu(gu[..., : down.shape[0]]) * gu[..., down.shape[0]:], down)

    def l2(y):
        yf = y.float()
        return (yf * torch.rsqrt(yf.pow(2).sum(-1, keepdim=True) + L2_EPS)).to(dt)

    b, s = tokens.shape
    dev = tokens.device
    keys = torch.arange(s, device=dev)
    x = weights["embed"][tokens].to(dt)
    for i in range(c["num_hidden_layers"]):
        p = f"layers.{i}."
        hn = norm(x, w(p + "attn_norm"))
        if i + 1 in kda_layers:
            qkv = F.silu(_causal_conv(mm(hn, w(p + "attn.qkv")), w(p + "attn.conv")))
            q, k, v = qkv.view(b, s, 3, h, hd).unbind(2)
            q, k = l2(q), l2(k)
            f_a, g_a, b_logit = mm(hn, w(p + "attn.gates")).split([hd, hd, h], -1)
            decay = F.softplus(mm(f_a, w(p + "attn.f_b")).float() + weights[p + "attn.dt_bias"])
            g = -torch.exp(weights[p + "attn.A_log"].float())[:, None] * decay.view(b, s, h, hd)
            beta = torch.sigmoid(b_logit.float())
            o = kda_recurrence(*(q8(t).float() for t in (q, k, v)), g, beta, hd ** -0.5)
            gate = torch.sigmoid(mm(g_a, w(p + "attn.g_b")).float()).view(b, s, h, hd)
            of = o.float()
            of = of * torch.rsqrt(of.pow(2).mean(-1, keepdim=True) + eps)
            o = (of * weights[p + "attn.o_norm"].float() * gate).to(dt)
            x = x + mm(o.reshape(b, s, h * hd), w(p + "attn.o"))
        else:
            q = mm(hn, w(p + "attn.q")).view(b, s, heads, nope + rope)
            kv_a = mm(hn, w(p + "attn.kv_a"))
            kv = mm(norm(kv_a[..., :rank], w(p + "attn.kv_a_norm")), w(p + "attn.kv_b"))
            kv = kv.view(b, s, heads, nope + dv)
            k_r = kv_a[..., rank:][:, :, None, :].expand(b, s, heads, rope)
            key = torch.cat([kv[..., :nope], k_r], -1)
            v = kv[..., nope:]
            a = torch.empty(b, s, heads, dv, dtype=dt, device=dev)
            for lo in range(0, s, BLOCK):
                hi = min(lo + BLOCK, s)
                scores = torch.einsum("bqhd,bkhd->bhqk", q8(q[:, lo:hi]), q8(key[:, :hi]))
                scores = scores.float() / math.sqrt(nope + rope)
                mask = keys[None, :hi] <= keys[lo:hi, None]
                probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1).to(dt)
                del scores
                a[:, lo:hi] = torch.einsum("bhqk,bkhd->bqhd", q8(probs), q8(v[:, :hi]))
                del probs
            x = x + mm(a.reshape(b, s, heads * dv), w(p + "attn.o"))
        hn = norm(x, w(p + "mlp_norm"))
        if i < c["first_k_dense_replace"]:
            x = x + swiglu(hn, w(p + "mlp.gate_up"), w(p + "mlp.down"))
            continue
        flat = hn.reshape(b * s, d)
        scores = torch.sigmoid(mm(flat, w(p + "moe.router").t()).float())
        choice = torch.topk(scores + weights[p + "moe.bias"].float(), topk, dim=-1).indices
        gate = scores.gather(1, choice)
        if c["moe_renormalize"]:
            gate = gate / (gate.sum(-1, keepdim=True) + 1e-20)
        gate = gate * float(c["routed_scaling_factor"])
        if loads is not None:
            mine = choice[(choice >= start) & (choice < start + held)]
            loads.append(torch.bincount(mine - start, minlength=held))
        routed = torch.zeros(b * s, d, dtype=torch.float32, device=dev)
        for e in range(held):
            tok, slot = torch.nonzero(choice == start + e, as_tuple=True)
            if tok.numel():
                y = swiglu(flat[tok], weights[p + "moe.gate_up"][e].to(dt),
                           weights[p + "moe.down"][e].to(dt))
                routed.index_add_(0, tok, y.float() * gate[tok, slot, None])
        shared = swiglu(flat, w(p + "moe.shared_gate_up"), w(p + "moe.shared_down"))
        x = x + (routed.to(dt) + shared).view(b, s, d)
    return norm(x, w("norm"))


def head_rows(rows: torch.Tensor, weights: Dict[str, torch.Tensor],
              fp8_control: bool = False) -> torch.Tensor:
    """Logits of the final hidden ``rows`` (N, d): float32, or float8
    values in bfloat16 (operands and logits rounded under a scale a block
    of ``ROWS`` rows, so no float32 copy of all the logits is made)."""
    if not fp8_control:
        return rows.float() @ weights["head"].float()
    head = fp8(weights["head"].to(torch.bfloat16))
    out = torch.empty(rows.shape[0], head.shape[1], dtype=torch.bfloat16, device=rows.device)
    for a in range(0, rows.shape[0], ROWS):
        out[a:a + ROWS] = fp8(fp8(rows[a:a + ROWS]) @ head)
    return out


def forward(weights: Dict[str, torch.Tensor], tokens: torch.Tensor, config: dict,
            fp8_control: bool = False) -> torch.Tensor:
    """Logits (B, S, V) of ``tokens`` (B, S), whole (for small sizes)."""
    return head_rows(hidden(weights, tokens, config, fp8_control), weights, fp8_control)


def route_load_gap(loads: List[torch.Tensor], ref_loads: List[torch.Tensor]) -> float:
    """Each MoE layer's per-expert loads, ``loads`` against ``ref_loads``
    (lists of (held,) counts, a layer each, as ``hidden`` gives them): the
    summed absolute differences over the reference's summed loads."""
    if len(loads) != len(ref_loads):
        return float("inf")
    gap = sum(float((a.cpu() - b.cpu()).abs().sum()) for a, b in zip(loads, ref_loads))
    return gap / max(sum(float(b.sum()) for b in ref_loads), 1.0)


def step_readings(logits: torch.Tensor, delta: Dict[str, float], ref_hidden: torch.Tensor,
                  weights: Dict[str, torch.Tensor], targets: torch.Tensor) -> Dict[str, float]:
    """``compare.step_readings`` with the reference's logits made from its
    final hidden rows ``ref_hidden`` (N, d) ``ROWS`` at a time, never
    whole: ``logits`` (N, V) as the step produced them, ``delta`` the
    metric states' change, ``targets`` (N,)."""
    num = den = 0.0
    nll_ref = []
    for a in range(0, logits.shape[0], ROWS):
        z = logits[a:a + ROWS].double()
        r = head_rows(ref_hidden[a:a + ROWS], weights).double()
        num += float(((z - r) ** 2).sum())
        den += float((r ** 2).sum())
        t = targets[a:a + ROWS].long()
        nll_ref.append(torch.logsumexp(r, dim=-1) - r.gather(1, t[:, None]).squeeze(1))
        del z, r
    nll = compare._token_nll(logits, targets)
    nll_ref = torch.cat(nll_ref)
    n = targets.numel()
    return {
        "logit_rms_rel": math.sqrt(num / den),
        "token_nll_gap_max": float((nll - nll_ref).abs().max()),
        "nll_sum_gap": abs(delta["sum_log_probs"] - float(nll.sum())) / n,
        "count_gap": abs(delta["ppl_count"] - n) + abs(delta["acc_count"] - n)
        + abs(delta["acc_correct"] - compare._argmax_hits(logits, targets)),
    }
