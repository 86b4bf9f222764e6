"""A DeepSeek-V3-family decoder LM: multi-head latent attention and a
dropless top-k mixture of experts (Moonlight-16B-A3B at its defaults).

The port's own model; the JAX package has no counterpart. Per layer::

    h = x + MLA(RMSNorm(x))
    y = h + FFN(RMSNorm(h))      FFN: a SwiGLU MLP in the first
                                 ``first_k_dense_replace`` layers, then MoE

then a final RMSNorm and an untied head. RMSNorm computes in float32 and
rounds to the activation dtype before its scale (as DeepSeek-V3's).

**MLA** (DeepSeek-V2/V3 without q-LoRA; H heads):

- ``q = x W_q``, split per head into ``qk_nope_head_dim`` and
  ``qk_rope_head_dim`` parts;
- ``[c_kv, k_rope] = x W_kv_a``: ``c_kv`` of ``kv_lora_rank`` dims, and
  one ``k_rope`` of ``qk_rope_head_dim`` dims that every head shares;
- ``c_kv`` through RMSNorm, then ``W_kv_b`` gives each head ``k_nope``
  and ``v``;
- RoPE (``rope_theta``, no scaling) on ``q_rope`` and ``k_rope`` in
  float32, in DeepSeek-V3's pair order: dims ``(2i, 2i+1)`` form the i-th
  pair (its complex number) and turn by ``pos * theta^(-2i / r)``, r the
  rope dims (the original release's ``view_as_complex``; Hugging Face's
  ``apply_rotary_pos_emb_interleave`` de-interleaves first, which permutes
  q and k alike and leaves every score unchanged);
- scores ``[q_nope, q_rope] . [k_nope, k_rope] / sqrt(nope + rope)`` under
  a causal mask, then ``softmax . v`` and ``W_o``: one
  ``F.scaled_dot_product_attention(is_causal=True)`` over the two head
  sizes as they are (on an H100 in bfloat16 torch picks cuDNN's fused
  attention for q/k of 192 and v of 128; its flash backend would need v
  padded to 192, which cuDNN also takes, 9 % slower).

**MoE** (``parallel.moe.moe_topk_dropless``): a float32 sigmoid router
over ``n_routed_experts``, the top ``num_experts_per_tok`` chosen on score
+ correction bias, normalised and scaled weights, SwiGLU experts of width
``moe_intermediate_size`` as grouped products, nothing dropped, and the
``n_shared_experts`` shared experts as one SwiGLU of their summed width.

Every kernel is ``(in, out)``, ``x @ W``; the experts are stacked
``(experts, in, out)`` with gate and up side by side (gate first). The
forward makes no host synchronisation. While the recorder is on (and a
profiler collects) each layer's attention is a ``torcheval.mla`` span and
the expert layer opens ``torcheval.moe.route``, ``torcheval.moe.experts``
and ``torcheval.moe.shared``; every forward counts in the ``moe`` counter
source. Build it on ``device="meta"`` and load its weights with
``load_state_dict(..., assign=True)`` to hold them once.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from torcheval_tpu_torch.obs import trace as _obs_trace
from torcheval_tpu_torch.obs.recorder import RECORDER as _OBS
from torcheval_tpu_torch.parallel.moe import moe_topk_dropless, note_forward, swiglu
from torcheval_tpu_torch.utils.convert import DeviceLike, canonicalize_device


@dataclass(frozen=True)
class MLAMoEConfig:
    """The architecture's sizes under their Hugging Face ``config.json``
    names; the defaults are Moonlight-16B-A3B's
    (moonshotai/Moonlight-16B-A3B, ``model_type`` ``deepseek_v3``)."""

    vocab_size: int = 163_840
    hidden_size: int = 2048
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    intermediate_size: int = 11_264
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 2.446
    rms_norm_eps: float = 1e-5
    rope_theta: float = 50_000.0
    max_position_embeddings: int = 8192

    @classmethod
    def from_dict(cls, config: Mapping[str, Any]) -> "MLAMoEConfig":
        """The sizes from a ``config.json``-style mapping (other keys
        ignored). Refuses what this model does not implement: q-LoRA,
        grouped routing, a router other than sigmoid ``noaux_tc``, MoE
        layers other than every layer after the dense ones, tied
        embeddings."""
        unsupported = {
            "q_lora_rank": None, "n_group": 1, "topk_group": 1, "scoring_func": "sigmoid",
            "topk_method": "noaux_tc", "moe_layer_freq": 1, "tie_word_embeddings": False,
            "attention_bias": False,
        }
        for key, want in unsupported.items():
            if key in config and config[key] != want:
                raise ValueError(f"{key}={config[key]!r} is not implemented (only {want!r})")
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in config.items() if k in names})

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """DeepSeek-V3's RMSNorm: normalised in float32, rounded to ``x``'s
    dtype, then scaled."""
    xf = x.float()
    xf = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return scale * xf.to(x.dtype)


def rope_tables(seq: int, dims: int, theta: float, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 ``(cos, sin)`` of shape ``(seq, dims / 2)``: pair i at
    position p turns by ``p * theta^(-2i / dims)``."""
    inv_freq = 1.0 / theta ** (torch.arange(0, dims, 2, device=device, dtype=torch.float32) / dims)
    angles = torch.arange(seq, device=device, dtype=torch.float32)[:, None] * inv_freq[None, :]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Turn each adjacent pair ``(x[2i], x[2i+1])`` of ``x``'s last axis
    by the angle whose ``cos``/``sin`` broadcast against ``x[..., ::2]``;
    computed in float32, returned in ``x``'s dtype."""
    xf = x.float()
    a, b = xf[..., 0::2], xf[..., 1::2]
    return torch.stack((a * cos - b * sin, a * sin + b * cos), dim=-1).flatten(-2).to(x.dtype)


def _param(*shape: int, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype))


class LatentAttention(nn.Module):
    """MLA without q-LoRA (module docstring). ``nope=True`` leaves q's
    rope dims and the shared ``k_rope`` unrotated (Kimi Linear's
    ``mla_use_nope``): attention with no position encoding."""

    def __init__(self, c: MLAMoEConfig, *, device, dtype, nope: bool = False) -> None:
        super().__init__()
        self.c = c
        self.nope = nope
        kw = dict(device=device, dtype=dtype)
        h = c.num_attention_heads
        self.q = _param(c.hidden_size, h * c.qk_head_dim, **kw)
        self.kv_a = _param(c.hidden_size, c.kv_lora_rank + c.qk_rope_head_dim, **kw)
        self.kv_a_norm = _param(c.kv_lora_rank, **kw)
        self.kv_b = _param(c.kv_lora_rank, h * (c.qk_nope_head_dim + c.v_head_dim), **kw)
        self.o = _param(h * c.v_head_dim, c.hidden_size, **kw)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        c = self.c
        b, s, _ = x.shape
        h, dv = c.num_attention_heads, c.v_head_dim
        nope, rope = c.qk_nope_head_dim, c.qk_rope_head_dim
        with _obs_trace.scope_or_null("torcheval.mla", _OBS.enabled):
            q_nope, q_rope = (x @ self.q).view(b, s, h, nope + rope).split([nope, rope], dim=-1)
            c_kv, k_rope = (x @ self.kv_a).split([c.kv_lora_rank, rope], dim=-1)
            kv = rms_norm(c_kv, self.kv_a_norm, c.rms_norm_eps) @ self.kv_b
            k_nope, v = kv.view(b, s, h, nope + dv).split([nope, dv], dim=-1)
            if not self.nope:
                q_rope = apply_rope(q_rope, cos[:, None, :], sin[:, None, :])
                k_rope = apply_rope(k_rope, cos, sin)
            k_rope = k_rope[:, :, None, :].expand(b, s, h, rope)
            q = torch.cat([q_nope, q_rope], dim=-1).transpose(1, 2)
            k = torch.cat([k_nope, k_rope], dim=-1).transpose(1, 2)
            out = F.scaled_dot_product_attention(q, k, v.transpose(1, 2), is_causal=True,
                                                 scale=1.0 / math.sqrt(nope + rope))
            return out.transpose(1, 2).reshape(b, s, h * dv) @ self.o


class DenseMLP(nn.Module):
    """SwiGLU of width ``intermediate_size``."""

    def __init__(self, c: MLAMoEConfig, *, device, dtype) -> None:
        super().__init__()
        self.gate_up = _param(c.hidden_size, 2 * c.intermediate_size, device=device, dtype=dtype)
        self.down = _param(c.intermediate_size, c.hidden_size, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return swiglu(x, self.gate_up, self.down)


class MoE(nn.Module):
    """The router over every expert, the stacked SwiGLU kernels of the
    experts held here and the shared experts (one SwiGLU of
    ``n_shared_experts x moe_intermediate_size``).

    ``expert_ids`` lists the global ids of the experts held here, in the
    order of the stacked kernels (a chip's share under expert
    parallelism); None holds all ``n_routed_experts`` in order. The router
    always scores all of them: a token routed to an expert not held here
    gets nothing from it (``moe_topk_dropless``). The ids' device tensor is
    made at the first forward on a device and kept."""

    def __init__(self, c: MLAMoEConfig, *, device, dtype,
                 expert_ids: Optional[Sequence[int]] = None) -> None:
        super().__init__()
        self.c = c
        kw = dict(device=device, dtype=dtype)
        d, f, e = c.hidden_size, c.moe_intermediate_size, c.n_routed_experts
        self.expert_ids = None if expert_ids is None else tuple(int(i) for i in expert_ids)
        if self.expert_ids is not None and not all(0 <= i < e for i in self.expert_ids):
            raise ValueError(f"expert ids {self.expert_ids} outside the router's {e} experts")
        held = e if self.expert_ids is None else len(self.expert_ids)
        self._ids: Dict[torch.device, torch.Tensor] = {}
        self.router = _param(e, d, **kw)
        self.bias = _param(e, **kw)
        self.gate_up = _param(held, d, 2 * f, **kw)
        self.down = _param(held, f, d, **kw)
        self.shared_gate_up = _param(d, 2 * f * c.n_shared_experts, **kw)
        self.shared_down = _param(f * c.n_shared_experts, d, **kw)

    def _held_ids(self, device: torch.device) -> Optional[torch.Tensor]:
        if self.expert_ids is None:
            return None
        ids = self._ids.get(device)
        if ids is None:
            ids = self._ids[device] = torch.tensor(self.expert_ids, dtype=torch.int64, device=device)
        return ids

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.c
        shared = (self.shared_gate_up, self.shared_down) if c.n_shared_experts else None
        y = moe_topk_dropless(
            x.reshape(-1, x.shape[-1]), self.router, self.bias, self.gate_up, self.down,
            k=c.num_experts_per_tok, norm_topk_prob=c.norm_topk_prob,
            routed_scaling_factor=c.routed_scaling_factor,
            expert_ids=self._held_ids(x.device), shared=shared)
        return y.view(x.shape)


class DecoderLayer(nn.Module):
    def __init__(self, c: MLAMoEConfig, index: int, *, device, dtype) -> None:
        super().__init__()
        self.eps = c.rms_norm_eps
        kw = dict(device=device, dtype=dtype)
        self.attn_norm = _param(c.hidden_size, **kw)
        self.attn = LatentAttention(c, **kw)
        self.mlp_norm = _param(c.hidden_size, **kw)
        self.dense = index < c.first_k_dense_replace
        if self.dense:
            self.mlp = DenseMLP(c, **kw)
        else:
            self.moe = MoE(c, **kw)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(rms_norm(x, self.attn_norm, self.eps), cos, sin)
        ffn = self.mlp if self.dense else self.moe
        return x + ffn(rms_norm(x, self.mlp_norm, self.eps))


class MLAMoELM(nn.Module):
    """Token embedding, ``num_hidden_layers`` decoder layers, a final
    RMSNorm and an untied head (module docstring). Parameters are left
    uninitialised: load them with ``load_state_dict``. ``device=None``
    means CUDA."""

    def __init__(
        self,
        config: Optional[MLAMoEConfig] = None,
        *,
        device: DeviceLike = None,
        dtype: torch.dtype = torch.bfloat16,
    ) -> None:
        super().__init__()
        c = config or MLAMoEConfig()
        device = canonicalize_device(device)
        kw = dict(device=device, dtype=dtype)
        self.config = c
        self.embed = _param(c.vocab_size, c.hidden_size, **kw)
        self.layers = nn.ModuleList(
            DecoderLayer(c, i, **kw) for i in range(c.num_hidden_layers))
        self.norm = _param(c.hidden_size, **kw)
        self.head = _param(c.hidden_size, c.vocab_size, **kw)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Logits ``(B, S, vocab_size)`` of ``tokens`` ``(B, S)``."""
        c = self.config
        note_forward()
        cos, sin = rope_tables(tokens.shape[-1], c.qk_rope_head_dim, c.rope_theta, tokens.device)
        x = F.embedding(tokens, self.embed)
        for layer in self.layers:
            x = layer(x, cos, sin)
        return rms_norm(x, self.norm, c.rms_norm_eps) @ self.head
