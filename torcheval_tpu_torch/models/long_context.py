"""Long-context transformer LM: ring attention at the model level.

Counterpart of ``torcheval_tpu/models/long_context.py``. One functional
forward serves both modes:

- ``group=None``: dense causal attention over the full sequence, the
  one-rank oracle;
- ``group=<sequence axis>``: ``tokens`` is this rank's contiguous block,
  attention runs as the exact ring (``parallel/ring_attention.py``) and
  positional embeddings index by GLOBAL position (``axis_index``).

Everything else (QKV/out projections, RMS norm, MLP, head) is per token,
so the sharded forward is the dense forward restricted to the local
block. Parameters are a plain dict of tensors, as the JAX package's are a
plain pytree; ``wqkv`` has shape ``(d_model, 3, n_heads, head_dim)``, so
the forward reads the head count from a weight's shape.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from torcheval_tpu_torch.metrics.functional.text.perplexity import (
    _perplexity_update_jit,
)
from torcheval_tpu_torch.parallel._axis import axis_index
from torcheval_tpu_torch.parallel.ring_attention import (
    dense_reference_attention,
    ring_attention,
)
from torcheval_tpu_torch.utils.convert import DeviceLike, canonicalize_device

Params = Dict[str, Any]


def init_long_context_lm(
    generator: torch.Generator,
    *,
    vocab_size: int,
    d_model: int,
    n_heads: int,
    n_layers: int,
    d_ff: int,
    max_len: int,
    device: DeviceLike = None,
) -> Params:
    """He/embedding-scaled float32 parameters drawn from ``generator``
    (which must live on ``device``; ``None`` means CUDA)."""
    if d_model % n_heads:
        raise ValueError(f"d_model {d_model} not divisible by n_heads {n_heads}")
    device = canonicalize_device(device)
    head_dim = d_model // n_heads

    def dense(shape, fan_in):
        return torch.randn(shape, generator=generator, device=device) * (fan_in ** -0.5)

    def ones():
        return torch.ones((d_model,), dtype=torch.float32, device=device)

    params: Params = {
        "tok_embed": dense((vocab_size, d_model), d_model ** 0.5),
        "pos_embed": dense((max_len, d_model), d_model ** 0.5),
        "head": dense((d_model, vocab_size), d_model),
        "final_ln_scale": ones(),
        "layers": [],
    }
    for _ in range(n_layers):
        params["layers"].append(
            {
                "ln1_scale": ones(),
                "wqkv": dense((d_model, 3, n_heads, head_dim), d_model),
                "wo": dense((d_model, d_model), d_model),
                "ln2_scale": ones(),
                "w_up": dense((d_model, d_ff), d_model),
                "w_down": dense((d_ff, d_model), d_ff),
            }
        )
    return params


def from_jax_params(params: Any, device: DeviceLike = None) -> Params:
    """The JAX package's parameter pytree (leaves as numpy arrays or
    anything ``np.asarray`` reads) as this module's tensors on
    ``device``."""
    device = canonicalize_device(device)
    if isinstance(params, dict):
        return {k: from_jax_params(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [from_jax_params(v, device) for v in params]
    return torch.from_numpy(np.array(params)).to(device)


def _rms_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * scale * torch.rsqrt(torch.mean(torch.square(x), dim=-1, keepdim=True) + 1e-6)


def long_context_lm(
    params: Params,
    tokens: torch.Tensor,
    *,
    group: Any = None,
) -> torch.Tensor:
    """Causal LM forward: ``(B, L)`` int tokens -> ``(B, L, V)`` logits.

    With ``group`` set, ``tokens`` is this rank's sequence block and
    attention runs as the exact ring over that axis; with ``group=None``
    it is the dense oracle.
    """
    _, local_len = tokens.shape
    d_model = params["tok_embed"].shape[1]

    # global positions: block i of the axis covers [i*L, (i+1)*L)
    offset = axis_index(group) * local_len if group is not None else 0
    positions = offset + torch.arange(local_len, device=tokens.device)
    x = params["tok_embed"][tokens] + params["pos_embed"][positions]

    for layer in params["layers"]:
        h = _rms_norm(x, layer["ln1_scale"])
        # (B, L, d) @ (d, 3, H, hd) -> (B, L, 3, H, hd); the head count is
        # the weight's own axis
        qkv = torch.einsum("bld,dcnh->blcnh", h, layer["wqkv"])
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if group is not None:
            attn = ring_attention(q, k, v, group=group, causal=True)
        else:
            attn = dense_reference_attention(q, k, v, causal=True)
        del qkv, q, k, v
        x = x + attn.reshape(*h.shape[:2], d_model) @ layer["wo"]
        h = _rms_norm(x, layer["ln2_scale"])
        x = x + F.gelu(h @ layer["w_up"], approximate="tanh") @ layer["w_down"]

    return _rms_norm(x, params["final_ln_scale"]) @ params["head"]


def perplexity_counters(
    logits: torch.Tensor,
    targets: torch.Tensor,
    *,
    ignore_index: Optional[int] = None,
) -> Dict[str, torch.Tensor]:
    """Perplexity sufficient statistics for one (local) logits block,
    SUM-mergeable, so a ``psum`` over the axes gives the global counters.
    Delegates to the metric's own update (the same ``ignore_index`` and
    out-of-range-target semantics)."""
    nll, count = _perplexity_update_jit(logits, targets, ignore_index)
    return {
        "sum_log_probs": nll,
        "num_total": count.to(torch.float32),
    }
