"""The collectives of a mesh axis, without ``shard_map``.

The JAX package runs ``parallel/`` inside ``shard_map`` over a named mesh
axis and speaks ``lax.psum``/``lax.axis_index``/``lax.ppermute``/
``lax.all_to_all``. The port is eager, one rank per process or thread,
and the axis becomes a ``group`` (the convention of
``metrics/sharded.py``). Two kinds of group are accepted:

- a ``torch.distributed`` group: a raw ``ProcessGroup``, or the port's
  ``MultiHostGroup`` (or a wrapper of one), whose communicator is used.
  ``ppermute`` is one ``batch_isend_irecv`` of ``P2POp``s, ``all_to_all``
  one ``all_to_all_single``, ``psum`` one ``all_reduce`` -- gloo on the
  CPU, NCCL on the card;
- a ``ThreadRankGroup`` view of a ``ThreadWorld``: tensors change hands
  by reference (``exchange_tensors``), which is the only way to run a
  ring of more than one rank on one card (NCCL refuses two ranks on one
  device).

A permute of a rank to itself is a copy, never a send (``torch.
distributed`` rejects a send to one's own rank; at world 1 every ring
hop is one), and a rank that no pair sends to receives zeros, as from
JAX's ``ppermute``. No counterpart of ``utils/vma.py``: eager torch has no
varying-axis typing to repair.

``census()`` counts, per thread, the collectives this module issues: the
torch analogue of counting collectives in a compiled program.
"""

from __future__ import annotations

import contextlib
import threading
from collections import Counter
from typing import Any, Iterator, List, Sequence, Tuple

import torch
import torch.distributed as dist

from torcheval_tpu_torch.distributed import ProcessGroup
from torcheval_tpu_torch.utils.test_utils.thread_world import ThreadRankGroup

__all__ = ["all_to_all", "axis_index", "axis_size", "census", "ppermute", "psum"]

_CENSUS = threading.local()


@contextlib.contextmanager
def census() -> Iterator[Counter]:
    """Count the collectives this thread issues inside the block, by name
    (``ppermute``, ``all_to_all``, ``psum``): one a call, whatever the
    number of tensors it moves."""
    counts: Counter = Counter()
    prev = getattr(_CENSUS, "counts", None)
    _CENSUS.counts = counts
    try:
        yield counts
    finally:
        _CENSUS.counts = prev


def _count(name: str) -> None:
    counts = getattr(_CENSUS, "counts", None)
    if counts is not None:
        counts[name] += 1


def _resolve(group: Any) -> Tuple[str, Any]:
    """``("thread", view)`` or ``("dist", torch group or None)``."""
    if isinstance(group, ProcessGroup):
        inner = group.unwrap()
        if isinstance(inner, ThreadRankGroup):
            if not inner.is_member:
                raise RuntimeError(f"rank is not a member of {inner.ranks}")
            return "thread", inner
        if hasattr(inner, "_group"):
            return "dist", inner._group
        raise TypeError(
            f"{type(inner).__name__} carries no device collectives; pass a "
            "torch.distributed group, a MultiHostGroup or a ThreadWorld view"
        )
    if isinstance(group, dist.ProcessGroup):
        return "dist", group
    raise TypeError(f"not a group: {group!r}")


def axis_size(group: Any) -> int:
    """The number of ranks on the axis (``lax.psum(1, axis_name)``)."""
    kind, g = _resolve(group)
    return g.world_size if kind == "thread" else dist.get_world_size(g)


def axis_index(group: Any) -> int:
    """This rank's index on the axis (``lax.axis_index``)."""
    kind, g = _resolve(group)
    return g.rank if kind == "thread" else dist.get_rank(g)


def _check_perm(perm: Sequence[Tuple[int, int]], size: int) -> None:
    srcs = [s for s, _ in perm]
    dsts = [d for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError(f"ppermute: sources and destinations must be unique, got {perm}")
    if any(not 0 <= r < size for r in srcs + dsts):
        raise ValueError(f"ppermute: rank out of range for an axis of {size}: {perm}")


def ppermute(x: Any, group: Any, perm: Sequence[Tuple[int, int]]) -> Any:
    """Send ``x`` (a tensor or a tuple of tensors, moved as one hop) from
    each source to its destination in ``perm``, a list of ``(src, dst)``
    axis indices. Returns what this rank receives: zeros where no pair
    targets it, a copy where it is its own source."""
    kind, g = _resolve(group)
    size = axis_size(group)
    me = axis_index(group)
    _check_perm(perm, size)
    _count("ppermute")
    items = x if isinstance(x, tuple) else (x,)
    src_of = {d: s for s, d in perm}
    dst_of = {s: d for s, d in perm}
    if kind == "thread":
        got = g.exchange_tensors(items)
        if me not in src_of:
            out = tuple(torch.zeros_like(t) for t in items)
        elif src_of[me] == me:
            out = tuple(t.clone() for t in items)
        else:
            out = got[src_of[me]]
    else:
        ops: List[dist.P2POp] = []
        out = tuple(
            t.clone() if src_of.get(me) == me else torch.zeros_like(t) for t in items
        )
        if me in dst_of and dst_of[me] != me:
            peer = dist.get_global_rank(g, dst_of[me]) if g is not None else dst_of[me]
            ops += [dist.P2POp(dist.isend, t.contiguous(), peer, g) for t in items]
        if me in src_of and src_of[me] != me:
            peer = dist.get_global_rank(g, src_of[me]) if g is not None else src_of[me]
            out = tuple(torch.empty_like(t, memory_format=torch.contiguous_format) for t in items)
            ops += [dist.P2POp(dist.irecv, t, peer, g) for t in out]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    return out if isinstance(x, tuple) else out[0]


def all_to_all(x: torch.Tensor, group: Any) -> torch.Tensor:
    """``lax.all_to_all(x, axis, 0, 0, tiled=True)``: split dim 0 into one
    block a rank, send block ``j`` to rank ``j``, and concatenate what
    arrives on dim 0 in source order."""
    kind, g = _resolve(group)
    size = axis_size(group)
    if x.shape[0] % size:
        raise ValueError(f"all_to_all: dim 0 ({x.shape[0]}) not divisible by {size} ranks")
    _count("all_to_all")
    if kind == "thread":
        me = g.rank
        return torch.cat([blocks.chunk(size)[me] for blocks in g.exchange_tensors(x)])
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, x.contiguous(), group=g)
    return out


def psum(x: torch.Tensor, group: Any) -> torch.Tensor:
    """The sum of ``x`` over the axis, on every rank (ranks added in
    order on a thread group)."""
    kind, g = _resolve(group)
    _count("psum")
    if kind == "thread":
        parts = g.exchange_tensors(x)
        total = parts[0].to(x.device, copy=True)
        for part in parts[1:]:
            total = total + part.to(x.device)
        return total
    out = x.clone()
    dist.all_reduce(out, group=g)
    return out
