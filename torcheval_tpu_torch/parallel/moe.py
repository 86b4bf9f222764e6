"""Expert parallelism: top-1 (Switch-style) MoE dispatch over an axis,
and a dropless top-k expert layer (DeepSeek-V3's router).

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

:func:`moe_topk_dropless` is the expert layer of the DeepSeek-V3 family
(``models/mla_moe.py``): sigmoid router scores over every expert, the top
``k`` chosen on score + correction bias, the chosen scores (not the bias)
as weights, normalised and scaled; SwiGLU experts computed as two grouped
matrix products over the experts held here, every routed pair kept; and
the shared experts. It makes no host synchronisation: the groups are sized
by device-side offsets (``torch._grouped_mm``'s ``offs``). The pairs each
held expert's grouped products compute (its rows between two offsets) are
accumulated on the device and read only when the ``moe`` counter source is
read (``moe_counts``), so a capped or short group shows there.

Spans (``obs/trace.scope_or_null``, open only while the recorder is on
and a profiler collects): ``torcheval.moe.route`` (the router, the sort by
expert and the offsets), ``torcheval.moe.experts`` (the gather of the
routed rows and the two grouped products) and ``torcheval.moe.shared``;
the un-sort and the weighted sum lie between them, in no span.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake

from torcheval_tpu_torch.obs import trace as _obs_trace
from torcheval_tpu_torch.obs.recorder import RECORDER as _OBS
from torcheval_tpu_torch.parallel._axis import all_to_all, axis_size, psum


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


# --------------------------------------------------------- dropless top-k

# routed-pair counts, process-wide and whether or not the recorder is on
# (as ``metrics._buffer.GROWTHS``): ``forwards`` is bumped by a model's
# forward (``note_forward``), ``routed_pairs`` by every call of
# ``moe_topk_dropless`` from its shapes, and so is ``held_pairs`` by a
# call that holds every expert; ``_LOADS`` holds each layer's per-expert
# computed pairs (keyed by its router's device and storage) as a device
# tensor, added to on the device and read back only by ``moe_counts`` and
# ``moe_loads``, and ``_HELD`` a device count, per device, of the pairs a call holding a
# share routed to its experts
_COUNTS: Dict[str, int] = {"forwards": 0, "routed_pairs": 0, "held_pairs": 0}  # tev: guarded-by=_COUNTS_LOCK
_LOADS: Dict[Tuple[str, int], torch.Tensor] = {}  # tev: guarded-by=_COUNTS_LOCK
_HELD: Dict[str, torch.Tensor] = {}  # tev: guarded-by=_COUNTS_LOCK
_COUNTS_LOCK = threading.Lock()


def note_forward() -> None:
    """Count one forward of a model whose layers route through
    :func:`moe_topk_dropless`."""
    with _COUNTS_LOCK:
        _COUNTS["forwards"] += 1


def moe_counts() -> Dict[str, float]:
    """The ``moe`` counter source: ``forwards``, ``routed_pairs`` (tokens x
    k summed over the calls, from shapes), ``held_pairs`` (the routed pairs
    whose expert is held here, counted from the router's choices: equal to
    ``routed_pairs`` while every expert is held), ``loaded_pairs`` (the
    pairs the grouped products computed, each held expert's rows between
    its offsets, summed: equal to ``held_pairs`` while every routed pair
    of a held expert is computed) and ``load_max_over_mean`` (the most
    loaded expert of any layer over the mean load of a layer's expert; 0
    before any call). Reading it synchronises with the device."""
    with _COUNTS_LOCK:
        out: Dict[str, float] = dict(_COUNTS)
        loads = [t.to("cpu", torch.float64) for t in _LOADS.values()]
        out["held_pairs"] += sum(int(t) for t in _HELD.values())
    every = torch.cat(loads) if loads else torch.zeros(1, dtype=torch.float64)
    out["loaded_pairs"] = int(every.sum())
    out["load_max_over_mean"] = float(every.max() / every.mean()) if out["loaded_pairs"] else 0.0
    return out


def moe_loads(router: torch.Tensor) -> Optional[torch.Tensor]:
    """The per-expert pairs computed so far by the expert layer whose
    router weight is ``router`` (int64 on the CPU, one entry an expert of
    the router, zero for an expert not held), or None before that layer's
    first call. Reading it synchronises with the device."""
    with _COUNTS_LOCK:
        loads = _LOADS.get((str(router.device), router.data_ptr()))
        return None if loads is None else loads.to("cpu", copy=True)


def _count_loads(loads: torch.Tensor, pairs: int, router: torch.Tensor,
                 held_pairs: Optional[torch.Tensor] = None) -> None:
    """Count a call's ``pairs`` routed, its per-expert ``loads`` and, for a
    call holding a share, ``held_pairs`` (a device scalar; None counts all
    ``pairs`` as held)."""
    if is_fake(loads):  # a FLOP count or a trace: nothing was routed
        return
    key = (str(loads.device), router.data_ptr())
    with _COUNTS_LOCK:
        _COUNTS["routed_pairs"] += pairs
        held = _LOADS.get(key)
        if held is None:
            _LOADS[key] = loads.clone()
        else:
            held.add_(loads)
        if held_pairs is None:
            _COUNTS["held_pairs"] += pairs
        elif key[0] in _HELD:
            _HELD[key[0]].add_(held_pairs)
        else:
            _HELD[key[0]] = held_pairs.clone()


def _held_groups(
    flat: torch.Tensor, routed: torch.Tensor, expert_ids: Optional[torch.Tensor], held: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each routed pair's group among the ``held`` experts held here, and
    each held expert's count of pairs, from the pairs' global expert ids
    ``flat`` and the global counts ``routed``. A pair for an expert not
    held here gets group ``held``: it sorts last, past the final offset,
    where the grouped products leave its rows."""
    if expert_ids is None:
        return flat, routed
    lookup = torch.full(routed.shape, held, dtype=torch.int64, device=flat.device)
    lookup[expert_ids] = torch.arange(held, device=flat.device)
    return lookup[flat], routed[expert_ids]


def route_topk(
    x: torch.Tensor,
    router_weight: torch.Tensor,
    correction_bias: torch.Tensor,
    k: int,
    norm_topk_prob: bool = True,
    routed_scaling_factor: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """DeepSeek-V3's ``noaux_tc`` gate with one expert group: float32
    logits ``x W_r^T``, sigmoid scores, the top ``k`` experts chosen on
    score + ``correction_bias``, each weighted by its score (the bias only
    chooses), the weights divided by their sum (+1e-20) when
    ``norm_topk_prob`` and scaled by ``routed_scaling_factor``.

    Returns ``(choice, weight)``: the chosen global expert ids ``(n, k)``
    (int64) and their float32 weights ``(n, k)``."""
    logits = x.float() @ router_weight.float().t()
    scores = torch.sigmoid(logits)
    choice = torch.topk(scores + correction_bias.float(), k, dim=-1, sorted=False).indices
    weight = scores.gather(1, choice)
    if norm_topk_prob:
        weight = weight / (weight.sum(dim=-1, keepdim=True) + 1e-20)
    return choice, weight * routed_scaling_factor


def swiglu(x: torch.Tensor, gate_up: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    """``(silu(x W_gate) * x W_up) W_down`` with ``gate_up = [W_gate,
    W_up]`` as ``(d, 2f)`` and ``down`` ``(f, d)``."""
    h = x @ gate_up
    f = down.shape[0]
    return (F.silu(h[..., :f]) * h[..., f:]) @ down


def moe_topk_dropless(
    x: torch.Tensor,
    router_weight: torch.Tensor,
    correction_bias: torch.Tensor,
    gate_up: torch.Tensor,
    down: torch.Tensor,
    *,
    k: int,
    norm_topk_prob: bool = True,
    routed_scaling_factor: float = 1.0,
    expert_ids: Optional[torch.Tensor] = None,
    shared: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    group: Any = None,
) -> torch.Tensor:
    """A dropless top-k expert layer over the experts held here.

    Args:
        x: ``(n, d)`` tokens (the same on every rank of ``group``).
        router_weight: ``(E, d)`` router over all ``E`` experts.
        correction_bias: ``(E,)`` added to the scores for the choice only.
        gate_up: ``(e, d, 2f)`` the held experts' SwiGLU gate and up
            kernels, side by side (gate first).
        down: ``(e, f, d)`` the held experts' down kernels.
        k, norm_topk_prob, routed_scaling_factor: the router's
            (:func:`route_topk`).
        expert_ids: ``(e,)`` int64 global ids of the held experts, in the
            order of ``gate_up``; None when all ``E`` are held, in order.
        shared: ``(gate_up (d, 2f_s), down (f_s, d))`` of the shared
            experts (one SwiGLU of their summed width), added once; None
            for none.
        group: an expert axis (``parallel/_axis.py``) whose ranks hold
            disjoint expert sets and the same tokens: the routed parts are
            summed over it (one ``psum``) before the shared experts are
            added. None makes no exchange.

    Every token is routed over all ``E`` experts; each held expert is
    applied to every token routed to it (no capacity, nothing dropped),
    the pairs sorted by expert and computed as two grouped products
    (``torch._grouped_mm`` over int32 offsets made on the device). A pair
    routed to an expert not held here adds nothing. The weighted sum of a
    token's pairs is one batched product (weights in ``x``'s dtype,
    accumulated in float32). Returns ``(n, d)`` in ``x``'s dtype. Each
    held expert's load, the rows between its offsets that the grouped
    products compute, is added to the ``moe`` counter source."""
    n, d = x.shape
    num_experts = router_weight.shape[0]
    held = gate_up.shape[0]
    f = down.shape[1]
    traced = _OBS.enabled
    with _obs_trace.scope_or_null("torcheval.moe.route", traced):
        choice, weight = route_topk(x, router_weight, correction_bias, k, norm_topk_prob,
                                    routed_scaling_factor)
        flat = choice.reshape(-1)
        routed = torch.zeros(num_experts, dtype=torch.int64, device=x.device)
        routed.scatter_add_(0, flat, torch.ones_like(flat))
        local, counts = _held_groups(flat, routed, expert_ids, held)
        order = torch.argsort(local, stable=True)
        offs = torch.cumsum(counts, 0).to(torch.int32)
        # the loads as the grouped products consume them: each held
        # expert's rows between its offsets
        loads = torch.diff(offs, prepend=offs.new_zeros(1)).to(torch.int64)
        held_pairs = None
        if expert_ids is not None:
            loads = routed.new_zeros(num_experts).index_add_(0, expert_ids, loads)
            held_pairs = routed[expert_ids].sum()
    _count_loads(loads, n * k, router_weight, held_pairs)
    with _obs_trace.scope_or_null("torcheval.moe.experts", traced):
        rows = x.index_select(0, order // k)
        h = torch._grouped_mm(rows, gate_up, offs=offs)
        h = F.silu(h[:, :f]) * h[:, f:]
        y = torch._grouped_mm(h, down, offs=offs)
    pairs = torch.empty_like(y).index_copy_(0, order, y)
    w = weight.reshape(-1)
    if expert_ids is not None:
        kept = local < held
        pairs = torch.where(kept[:, None], pairs, 0)
        w = torch.where(kept, w, 0.0)
    # one batched product a token: its k outputs weighted and summed,
    # accumulated in float32, rounded once
    out = torch.bmm(w.reshape(n, 1, k).to(x.dtype), pairs.reshape(n, k, d)).reshape(n, d)
    if group is not None:
        out = psum(out, group)
    if shared is not None:
        with _obs_trace.scope_or_null("torcheval.moe.shared", traced):
            out = out + swiglu(x, *shared)
    return out


def moe_topk_reference(
    x: torch.Tensor,
    router_weight: torch.Tensor,
    correction_bias: torch.Tensor,
    gate_up: torch.Tensor,
    down: torch.Tensor,
    *,
    k: int,
    norm_topk_prob: bool = True,
    routed_scaling_factor: float = 1.0,
    expert_ids: Optional[torch.Tensor] = None,
    shared: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Oracle of :func:`moe_topk_dropless` without a group: the same
    routing, each held expert applied in a loop to the rows routed to it
    (``nonzero``: it reads the device)."""
    choice, weight = route_topk(x, router_weight, correction_bias, k, norm_topk_prob,
                                routed_scaling_factor)
    ids = range(gate_up.shape[0]) if expert_ids is None else expert_ids.tolist()
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for local, e in enumerate(ids):
        tok, slot = torch.nonzero(choice == e, as_tuple=True)
        if tok.numel():
            y = swiglu(x[tok], gate_up[local], down[local]).float()
            out.index_add_(0, tok, y * weight[tok, slot, None])
    out = out.to(x.dtype)
    if shared is not None:
        out = out + swiglu(x, *shared)
    return out
