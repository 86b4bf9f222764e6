"""Expert parallelism: top-1 (Switch-style) MoE dispatch over an axis.

Counterpart of ``torcheval_tpu/parallel/moe.py``. Experts are one a rank
of an ``ep`` axis and tokens are sharded over the same axis. Each rank
routes its tokens with a softmax gate, packs them into a fixed-capacity
``(E, C, d)`` dispatch buffer (tokens past an expert's capacity are
dropped and their output is zero), exchanges buffers with one
``all_to_all``, applies its resident expert FFN to every token it
received in one matmul, and returns the results with a second
``all_to_all``. The gate probability weights the result at the source,
so the combine is a gather, not a collective.

The axis is a ``group`` (``parallel/_axis.py``)::

    y = moe_apply(x_shard, wg, w1[rank], w2[rank], group=ep_group, capacity=C)
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from torcheval_tpu_torch.parallel._axis import all_to_all, axis_size


def _route(
    x: torch.Tensor, wg: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-1 gating: per-token expert index (the first maximum), gate
    probability, and the token's arrival position within its expert's
    queue (source order; an int32 running count of the one-hots)."""
    probs = torch.softmax(x @ wg, dim=-1)
    expert = torch.argmax(probs, dim=-1)
    gate = torch.amax(probs, dim=-1)
    onehot = torch.nn.functional.one_hot(expert, wg.shape[-1]).to(torch.int32)
    position = torch.sum((torch.cumsum(onehot, dim=0, dtype=torch.int32) - 1) * onehot, dim=-1)
    return expert, gate, position


def moe_apply(
    x: torch.Tensor,
    wg: torch.Tensor,
    w1: torch.Tensor,
    w2: torch.Tensor,
    *,
    group: Any,
    capacity: int,
) -> torch.Tensor:
    """Dispatch this rank's tokens through the rank-sharded experts.

    Args:
        x: ``(n, d)`` this rank's token shard.
        wg: ``(d, E)`` gate weights, the same on every rank.
        w1: ``(d, h)`` this rank's expert up-projection.
        w2: ``(h, d)`` this rank's expert down-projection.
        group: the expert axis (E = its size).
        capacity: most tokens each (source rank, expert) pair may send;
            overflow tokens get zero output.

    Returns the ``(n, d)`` combined output: ``gate * expert(x)`` a kept
    token, zero a dropped one.
    """
    num_experts = axis_size(group)
    n, d = x.shape
    expert, gate, position = _route(x, wg)
    keep = position < capacity

    # pack into (E, C+1, d); slot C is the spill row every dropped token
    # writes to (and is then cut off), so kept tokens never collide
    slot = torch.where(keep, position, capacity).to(torch.int64)
    dispatch = torch.zeros((num_experts, capacity + 1, d), dtype=x.dtype, device=x.device)
    dispatch[expert, slot] = x
    dispatch = dispatch[:, :capacity]

    # exchange: the leading axis goes from "destination expert" to "source
    # rank"; each rank now holds every shard's tokens for ITS expert
    received = all_to_all(dispatch, group)

    hidden = torch.relu(received.reshape(-1, d) @ w1)
    processed = (hidden @ w2).reshape(num_experts, capacity, d)

    # send results back and gather each token's row from its expert buffer
    returned = all_to_all(processed, group)
    padded = torch.cat(
        [returned, torch.zeros((num_experts, 1, d), dtype=returned.dtype, device=x.device)],
        dim=1,
    )
    return padded[expert, slot] * gate[:, None]


def moe_reference(
    x: torch.Tensor,
    wg: torch.Tensor,
    w1: torch.Tensor,
    w2: torch.Tensor,
    *,
    num_shards: int,
    capacity: int,
) -> torch.Tensor:
    """Unsharded oracle with the same routing and drop semantics.

    ``x`` is the full ``(N, d)`` batch laid out as ``num_shards``
    contiguous shards; ``w1``/``w2`` carry the expert axis in front
    (``(E, d, h)`` / ``(E, h, d)``). The JAX oracle gathers ``w1[expert]``
    a token, which at Switch-Base width over 16,384 tokens would hold
    155 GB; this loops over the experts instead, each applied to the rows
    routed to it.
    """
    outs = []
    for shard in torch.chunk(x, num_shards, dim=0):
        expert, gate, position = _route(shard, wg)
        keep = position < capacity
        y = torch.zeros_like(shard)
        for e in range(w1.shape[0]):
            rows = torch.nonzero(expert == e).squeeze(1)
            if rows.numel():
                y[rows] = torch.relu(shard[rows] @ w1[e]) @ w2[e]
        outs.append(torch.where(keep[:, None], y * gate[:, None], 0.0))
    return torch.cat(outs, dim=0)
