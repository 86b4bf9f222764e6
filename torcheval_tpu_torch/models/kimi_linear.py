"""Kimi Linear (``model_type`` ``kimi_linear``): a hybrid decoder LM of
Kimi Delta Attention (KDA) layers and NoPE latent attention, with the
DeepSeek-V3 expert layer (Kimi-Linear-48B-A3B at its defaults).

The port's own model; the JAX package has no counterpart. Per layer::

    h = x + Mixer(RMSNorm(x))     Mixer: KDA for the layers listed in
                                  ``linear_attn_config["kda_layers"]``, MLA
                                  for ``full_attn_layers`` (1-indexed)
    y = h + FFN(RMSNorm(h))       FFN: a SwiGLU MLP in the first
                                  ``first_k_dense_replace`` layers, then MoE

then a final RMSNorm and an untied head. RMSNorm, ``DenseMLP``, the expert
layer (``MoE``) and MLA (``LatentAttention``) are ``models/mla_moe.py``'s,
the last with ``nope=mla_use_nope``: q's ``qk_rope_head_dim`` dims and the
shared ``k_rope`` stay unrotated.

**KDA** (Kimi Linear report, arXiv:2510.26692; H heads of d = ``head_dim``
of ``linear_attn_config``):

- ``q, k, v = SiLU(conv4(x W_{q,k,v}))``: a causal depthwise convolution
  of kernel ``short_conv_kernel_size`` a channel, no bias (the three
  projections run as one product over 3 H d channels);
- q and k L2-normalised a head (``x / sqrt(sum x^2 + 1e-6)``), q scaled by
  ``d^-1/2`` in the scan; the convolutions, SiLU and norms are
  ``ops.kda.conv_qkv``, one kernel on the card;
- ``g = -exp(A_log) softplus(x W_f_a W_f_b + dt_bias)`` in float32: a
  per-channel log decay through a rank-d projection, ``A_log`` one a head;
- ``beta = sigmoid(x W_b)`` in float32, one a head;
- the gated delta rule ``S_t = (I - beta_t k_t k_t^T) Diag(exp g_t)
  S_{t-1} + beta_t k_t v_t^T``, ``o_t = S_t^T q_t``
  (``ops.kda.kda_chunked``: one hand-written kernel pair on the card);
- ``out = W_o [RMSNorm_head(o) * w * sigmoid(x W_g_a W_g_b)]``, the
  norm and gate in float32, rounded once.

``W_f_a``, ``W_g_a`` and ``W_b`` all read x and run as one product
(``gates``). While the recorder is on (and a profiler collects) each KDA
mixer is a ``torcheval.kda`` span and its scan alone ``torcheval.kda.scan``;
MLA and the expert layer open theirs (``torcheval.mla``,
``torcheval.moe.*``). The forward makes no host synchronisation (the held
experts' ids reach the device at the first forward on it). Build it on
``device="meta"`` and load its weights with ``load_state_dict(...,
assign=True)`` to hold them once.

**Held experts.** ``num_experts`` counts the experts held here, a chip's
share under expert parallelism, and ``router_experts`` the experts the
router scores (the published count); the held ones are ``held_expert_start
.. + num_experts``. A token routed to an expert not held here gets nothing
from it on this chip, as the deployment's other chips would add it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from torcheval_tpu_torch.models.mla_moe import (
    DenseMLP,
    LatentAttention,
    MLAMoEConfig,
    MoE,
    _param,
    rms_norm,
    rope_tables,
)
from torcheval_tpu_torch.obs import trace as _obs_trace
from torcheval_tpu_torch.obs.recorder import RECORDER as _OBS
from torcheval_tpu_torch.ops.kda import conv_qkv, kda_chunked
from torcheval_tpu_torch.parallel.moe import note_forward
from torcheval_tpu_torch.utils.convert import DeviceLike, canonicalize_device


def _published_layers() -> Dict[str, Any]:
    return {
        "full_attn_layers": [4, 8, 12, 16, 20, 24, 27],
        "kda_layers": [1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15, 17, 18, 19, 21, 22, 23, 25, 26],
        "head_dim": 128,
        "num_heads": 32,
        "short_conv_kernel_size": 4,
    }


@dataclass(frozen=True)
class KimiLinearConfig:
    """The architecture's sizes under their ``config.json`` names; the
    defaults are Kimi-Linear-48B-A3B-Instruct's
    (moonshotai/Kimi-Linear-48B-A3B-Instruct) with every expert held."""

    vocab_size: int = 163_840
    hidden_size: int = 2304
    num_hidden_layers: int = 27
    num_attention_heads: int = 32
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    intermediate_size: int = 9216
    moe_intermediate_size: int = 1024
    num_experts: int = 256
    num_experts_per_token: int = 8
    num_shared_experts: int = 1
    first_k_dense_replace: int = 1
    moe_renormalize: bool = True
    routed_scaling_factor: float = 2.446
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10_000.0
    model_max_length: int = 1_048_576
    mla_use_nope: bool = True
    linear_attn_config: Mapping[str, Any] = field(default_factory=_published_layers)
    router_experts: Optional[int] = None
    held_expert_start: int = 0

    @classmethod
    def from_dict(cls, config: Mapping[str, Any]) -> "KimiLinearConfig":
        """The sizes from a ``config.json``-style mapping (other keys
        ignored). Refuses what this model does not implement: q-LoRA,
        grouped routing, a router other than sigmoid, MoE layers other than
        every layer after the dense ones, tied embeddings, a layer listed as
        neither or both kinds."""
        unsupported = {
            "q_lora_rank": None, "num_expert_group": 1, "topk_group": 1,
            "moe_router_activation_func": "sigmoid", "moe_layer_freq": 1,
            "tie_word_embeddings": False, "rope_scaling": None,
        }
        for key, want in unsupported.items():
            if key in config and config[key] != want:
                raise ValueError(f"{key}={config[key]!r} is not implemented (only {want!r})")
        names = {f.name for f in dataclasses.fields(cls)}
        c = cls(**{k: v for k, v in config.items() if k in names})
        c.layer_kinds()
        return c

    @property
    def router_width(self) -> int:
        return self.num_experts if self.router_experts is None else self.router_experts

    @property
    def held_expert_ids(self) -> Optional[range]:
        """The global ids of the experts held here; None when all are."""
        if self.router_width == self.num_experts and self.held_expert_start == 0:
            return None
        return range(self.held_expert_start, self.held_expert_start + self.num_experts)

    def layer_kinds(self) -> tuple:
        """``"kda"`` or ``"mla"`` for each layer, from the 1-indexed lists
        of ``linear_attn_config``."""
        kda = set(self.linear_attn_config["kda_layers"])
        full = set(self.linear_attn_config.get("full_attn_layers") or ())
        kinds = []
        for i in range(1, self.num_hidden_layers + 1):
            if (i in kda) == (i in full):
                raise ValueError(f"layer {i} is listed as {'both kinds' if i in kda else 'neither kind'}")
            kinds.append("kda" if i in kda else "mla")
        return tuple(kinds)

    def mla_config(self) -> MLAMoEConfig:
        """The shared modules' sizes (``models/mla_moe.py``), the router at
        its full width."""
        return MLAMoEConfig(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            num_hidden_layers=self.num_hidden_layers,
            num_attention_heads=self.num_attention_heads, kv_lora_rank=self.kv_lora_rank,
            qk_nope_head_dim=self.qk_nope_head_dim, qk_rope_head_dim=self.qk_rope_head_dim,
            v_head_dim=self.v_head_dim, intermediate_size=self.intermediate_size,
            moe_intermediate_size=self.moe_intermediate_size, n_routed_experts=self.router_width,
            n_shared_experts=self.num_shared_experts,
            num_experts_per_tok=self.num_experts_per_token,
            first_k_dense_replace=self.first_k_dense_replace,
            norm_topk_prob=self.moe_renormalize, routed_scaling_factor=self.routed_scaling_factor,
            rms_norm_eps=self.rms_norm_eps, rope_theta=self.rope_theta,
            max_position_embeddings=self.model_max_length)


class KimiDeltaAttention(nn.Module):
    """The KDA token mixer (module docstring)."""

    def __init__(self, c: KimiLinearConfig, *, device, dtype) -> None:
        super().__init__()
        la = c.linear_attn_config
        h, d, w = la["num_heads"], la["head_dim"], la["short_conv_kernel_size"]
        self.heads, self.head_dim, self.eps = h, d, c.rms_norm_eps
        kw = dict(device=device, dtype=dtype)
        f32 = dict(device=device, dtype=torch.float32)
        self.qkv = _param(c.hidden_size, 3 * h * d, **kw)
        self.conv = _param(3 * h * d, w, **kw)
        self.gates = _param(c.hidden_size, 2 * d + h, **kw)
        self.f_b = _param(d, h * d, **kw)
        self.dt_bias = _param(h * d, **f32)
        self.A_log = _param(h, **f32)
        self.g_b = _param(d, h * d, **kw)
        self.o_norm = _param(d, **kw)
        self.o = _param(h * d, c.hidden_size, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        h, d = self.heads, self.head_dim
        traced = _OBS.enabled
        with _obs_trace.scope_or_null("torcheval.kda", traced):
            q, k, v = conv_qkv(x @ self.qkv, self.conv, h, d)
            f_a, g_a, b_logit = (x @ self.gates).split([d, d, h], dim=-1)
            decay = F.softplus((f_a @ self.f_b).float() + self.dt_bias).view(b, s, h, d)
            g = -torch.exp(self.A_log)[:, None] * decay
            beta = torch.sigmoid(b_logit.float())
            with _obs_trace.scope_or_null("torcheval.kda.scan", traced):
                o = kda_chunked(q, k, v, g, beta, d ** -0.5)
            of = o.float()
            of = of * torch.rsqrt(of.pow(2).mean(-1, keepdim=True) + self.eps)
            gate = torch.sigmoid((g_a @ self.g_b).float()).view(b, s, h, d)
            o = (of * self.o_norm.float() * gate).to(x.dtype)
            return o.reshape(b, s, h * d) @ self.o


class KimiDecoderLayer(nn.Module):
    def __init__(self, c: KimiLinearConfig, index: int, kind: str, *, device, dtype) -> None:
        super().__init__()
        mc = c.mla_config()
        self.eps = c.rms_norm_eps
        kw = dict(device=device, dtype=dtype)
        self.attn_norm = _param(c.hidden_size, **kw)
        self.kind = kind
        if kind == "kda":
            self.attn = KimiDeltaAttention(c, **kw)
        else:
            self.attn = LatentAttention(mc, nope=c.mla_use_nope, **kw)
        self.mlp_norm = _param(c.hidden_size, **kw)
        self.dense = index < c.first_k_dense_replace
        if self.dense:
            self.mlp = DenseMLP(mc, **kw)
        else:
            self.moe = MoE(mc, expert_ids=c.held_expert_ids, **kw)

    def forward(self, x: torch.Tensor, cos, sin) -> torch.Tensor:
        h = rms_norm(x, self.attn_norm, self.eps)
        x = x + (self.attn(h) if self.kind == "kda" else self.attn(h, cos, sin))
        ffn = self.mlp if self.dense else self.moe
        return x + ffn(rms_norm(x, self.mlp_norm, self.eps))


class KimiLinearLM(nn.Module):
    """Token embedding, ``num_hidden_layers`` decoder layers of the kinds
    ``linear_attn_config`` lists, a final RMSNorm and an untied head
    (module docstring). Parameters are left uninitialised: load them with
    ``load_state_dict``. ``device=None`` means CUDA."""

    def __init__(
        self,
        config: Optional[KimiLinearConfig] = None,
        *,
        device: DeviceLike = None,
        dtype: torch.dtype = torch.bfloat16,
    ) -> None:
        super().__init__()
        c = config or KimiLinearConfig()
        device = canonicalize_device(device)
        kw = dict(device=device, dtype=dtype)
        self.config = c
        self.embed = _param(c.vocab_size, c.hidden_size, **kw)
        self.layers = nn.ModuleList(
            KimiDecoderLayer(c, i, kind, **kw) for i, kind in enumerate(c.layer_kinds()))
        self.norm = _param(c.hidden_size, **kw)
        self.head = _param(c.hidden_size, c.vocab_size, **kw)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Logits ``(B, S, vocab_size)`` of ``tokens`` ``(B, S)``."""
        c = self.config
        note_forward()
        cos = sin = None
        if not c.mla_use_nope:
            cos, sin = rope_tables(tokens.shape[-1], c.qk_rope_head_dim, c.rope_theta,
                                   tokens.device)
        x = F.embedding(tokens, self.embed)
        for layer in self.layers:
            x = layer(x, cos, sin)
        return rms_norm(x, self.norm, c.rms_norm_eps) @ self.head
