"""Ring attention: exact attention over sequence-sharded inputs.

Counterpart of ``torcheval_tpu/parallel/ring_attention.py``. Each rank of
the sequence axis holds one contiguous block of queries, keys and values;
each of P steps combines the resident query block with the key/value
block it holds, by the online-softmax (flash) accumulation in float32,
then passes the key/value block and its block index one hop around the
ring (rank i -> i+1). The JAX scan also passes after the last step, a
wasted hop, and so does this: P ``ppermute`` calls an attention call,
each moving (k, v, kv index) together.

The axis is a ``group`` (``parallel/_axis.py``): a ``torch.distributed``
group or a ``ThreadWorld`` view::

    out = ring_attention(q_block, k_block, v_block, group=sp_group, causal=True)

The dense oracle is the JAX package's: plain einsum and softmax with the
``NEG_INF`` mask, not ``scaled_dot_product_attention`` (which masks with
``-inf`` and orders its operations otherwise).
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from torcheval_tpu_torch.parallel._axis import axis_index, axis_size, ppermute

NEG_INF = -1e30  # large-negative instead of -inf: keeps exp()/max() NaN-free


def _block_attend(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_offset: Any,
    kv_offset: Any,
    causal: bool,
    scale: float,
) -> torch.Tensor:
    """Scores of one (q-block, kv-block) pair with global-position causal
    masking. Shapes: q (B, nq, H, D), k/v (B, nk, H, D)."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        kv_pos = kv_offset + torch.arange(k.shape[1], device=q.device)
        mask = q_pos[:, None] >= kv_pos[None, :]
        scores = torch.where(mask[None, None, :, :], scores, NEG_INF)
    return scores


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    group: Any,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Exact multi-head attention over a sequence-sharded (B, S/P, H, D)
    layout: this rank's query, key and value blocks in, its (B, S/P, H, D)
    output block out. ``group`` is the sequence axis. Numerically the
    dense softmax attention over the gathered sequence (the online-softmax
    accumulation is exact, not approximate)."""
    num_shards = axis_size(group)
    my_index = axis_index(group)
    batch, nq, heads, dim = q.shape
    scale = scale if scale is not None else dim ** -0.5
    block = nq  # equal-size sequence blocks per rank
    q_offset = my_index * block

    acc = torch.zeros((batch, heads, nq, dim), dtype=torch.float32, device=q.device)
    denom = torch.zeros((batch, heads, nq), dtype=torch.float32, device=q.device)
    running_max = torch.full((batch, heads, nq), NEG_INF, dtype=torch.float32, device=q.device)

    perm = [(i, (i + 1) % num_shards) for i in range(num_shards)]
    k_blk, v_blk = k, v
    kv_index = torch.tensor(my_index, dtype=torch.int64, device=q.device)
    for _ in range(num_shards):
        scores = _block_attend(q, k_blk, v_blk, q_offset, kv_index * block, causal, scale)
        new_max = torch.maximum(running_max, torch.amax(scores, dim=-1))
        correction = torch.exp(running_max - new_max)
        p = torch.exp(scores - new_max[..., None])
        del scores
        denom = denom * correction + torch.sum(p, dim=-1)
        acc = acc * correction[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p, v_blk.to(torch.float32)
        )
        del p
        running_max = new_max
        # rotate K/V (and which block they are) one hop around the ring
        k_blk, v_blk, kv_index = ppermute((k_blk, v_blk, kv_index), group, perm)

    # fully-masked rows cannot occur under causal=True (each q sees itself);
    # guard anyway so non-causal edge shards stay finite
    out = acc / torch.clamp(denom, min=1e-30)[..., None]
    return torch.einsum("bhqd->bqhd", out).to(q.dtype)


def dense_reference_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Unsharded oracle with identical semantics (tests / one rank)."""
    dim = q.shape[-1]
    scale = scale if scale is not None else dim ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        nq, nk = scores.shape[-2], scores.shape[-1]
        mask = (
            torch.arange(nq, device=q.device)[:, None]
            >= torch.arange(nk, device=q.device)[None, :]
        )
        scores = torch.where(mask[None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    del scores
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
