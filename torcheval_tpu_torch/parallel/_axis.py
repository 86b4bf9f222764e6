"""The collectives of a mesh axis, without ``shard_map``, and their backward.

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

**Gradients.** Each collective's backward is itself a collective: the
backward of ``ppermute`` is ``ppermute`` of the cotangents with every pair
reversed (a rank that no pair targeted got zeros, and its cotangent goes
nowhere; an item with no destination gets a zero gradient; a self-pair is
a copy both ways), of the tiled ``all_to_all`` the same ``all_to_all`` of
the cotangent, of ``psum`` the ``psum`` of the cotangent. Integer items
(ring attention's block index) carry none. The convention is
``shard_map``'s for a sharded output: the loss is the SUM of every rank's
loss. So a loss read off a replicated output (``pipeline_apply``'s, a
``psum``) is divided by the axis size on every rank (or taken on one rank
while the others back-propagate zeros), and the gradient of an input that
every rank holds whole (MoE's ``wg``, GPipe's ``x``) is the sum over the
ranks of each rank's gradient, as ``shard_map``'s transpose gives it.

The backward is driven by :func:`backward`, called on every rank in
lockstep, not by ``loss.backward()``. Under grad mode a collective that
records exchanges DETACHED tensors (no rank's graph reaches into
another's), hands back leaves that require grad, and records (sent,
received) on this thread's tape. On a ``ThreadWorld`` view it records
when any rank's float item requires grad (the flags ride the exchange);
on a ``torch.distributed`` group, where a rank cannot see its peers'
flags without a collective of its own, when one of its own float items
does, so the ranks must hold items that require grad alike (``backward``
raises when they recorded different calls). ``backward`` first gathers
each rank's recorded calls and reachability on the tape's group (counted
as ``backward_plan``) and drops every entry whose received values reach
no rank's loss, there or through a later entry's sent values, with its
graph and without a collective: a forward under grad mode that no loss
reads (an evaluation pass that forgot ``torch.no_grad()``) is freed at
the next ``backward``, and ring attention's last, wasted hop moves
nothing back. (A tape on several groups keeps every entry.) It then runs
autograd from the loss down to the received leaves, exchanges their
cotangents on the rank's own thread, continues from the sent tensors,
and so on in reverse tape order. Autograd itself cannot run a collective
in a backward node: on the card it runs every CUDA node on one device
thread shared by all rank threads, so the first rank to block in an
exchange stalls its peers' backward for good; and a rank whose received
value does not reach its own loss (GPipe's first stage) would never run
its node while its peers wait on it. ``loss.backward()`` on a graph
through a recorded collective raises. Run forward-only code under
``torch.no_grad()``: no tape, tensors by reference as before; a recorded
forward holds its graph until the thread's next ``backward``.

``census()`` counts, per thread, the collectives this module issues: the
torch analogue of counting collectives in a compiled program. Backward
collectives count under ``<name>_bwd``, the plan under ``backward_plan``.
"""

from __future__ import annotations

import contextlib
import threading
from collections import Counter
from typing import Any, Iterator, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.autograd.graph import get_gradient_edge

from torcheval_tpu_torch.distributed import ProcessGroup, gather_transport
from torcheval_tpu_torch.utils.test_utils.thread_world import ThreadRankGroup

__all__ = [
    "all_to_all",
    "axis_index",
    "axis_size",
    "backward",
    "census",
    "ppermute",
    "psum",
]

_CENSUS = threading.local()
_LOCAL = threading.local()


@contextlib.contextmanager
def census() -> Iterator[Counter]:
    """Count the collectives this thread issues inside the block, by name
    (``ppermute``, ``all_to_all``, ``psum``, and ``backward_plan`` and
    ``<name>_bwd`` in :func:`backward`): one a call, whatever the number
    of tensors it moves."""
    counts: Counter = Counter()
    prev = getattr(_CENSUS, "counts", None)
    _CENSUS.counts = counts
    try:
        yield counts
    finally:
        _CENSUS.counts = prev


def add_listener(fn) -> Any:
    """Call ``fn(name)`` on every collective this thread issues from now
    on, in order (the census counts by name; a listener sees the sequence:
    ``analysis.program`` and ``analysis.lockstep`` record plans with it).
    Returns ``fn``, the handle for :func:`remove_listener`."""
    listeners = getattr(_CENSUS, "listeners", None)
    if listeners is None:
        listeners = _CENSUS.listeners = []
    listeners.append(fn)
    return fn


def remove_listener(fn) -> None:
    _CENSUS.listeners.remove(fn)


def _count(name: str) -> None:
    counts = getattr(_CENSUS, "counts", None)
    if counts is not None:
        counts[name] += 1
    for fn in getattr(_CENSUS, "listeners", ()):
        fn(name)


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


# ------------------------------------------------------------------ the tape


class _Tape:
    """This thread's recorded collectives, oldest first."""

    def __init__(self) -> None:
        self.entries: List["_Entry"] = []
        self.calls: dict = {}  # forward calls on each group (by id) since the last backward
        self.running = False  # inside backward(): the leaves' hooks let grads through


class _Entry(NamedTuple):
    kind: str
    group: Any
    call: int  # its number among its group's calls since the last backward
    perm: Tuple[Tuple[int, int], ...]
    sent: Tuple[Optional[torch.Tensor], ...]  # float items as sent, graph attached
    received: Tuple[Optional[torch.Tensor], ...]  # float items received, leaves


def _tape() -> _Tape:
    tape = getattr(_LOCAL, "tape", None)
    if tape is None:
        tape = _LOCAL.tape = _Tape()
    return tape


def _is_float(t: Any) -> bool:
    return isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex())


def _wants_grad(items: Sequence[torch.Tensor]) -> bool:
    return torch.is_grad_enabled() and any(_is_float(t) and t.requires_grad for t in items)


def _leaf(t: torch.Tensor, tape: _Tape) -> torch.Tensor:
    """A received float item as a leaf of this rank's graph."""
    leaf = t.detach().requires_grad_(True)

    def guard(grad: torch.Tensor) -> torch.Tensor:
        if not tape.running:
            raise RuntimeError(
                "this graph runs through a parallel collective: call "
                "torcheval_tpu_torch.parallel.backward(loss) on every rank, "
                "not loss.backward()"
            )
        return grad

    leaf.register_hook(guard)
    return leaf


def _begin_call(name: str, g: Any) -> int:
    """Count a forward call in the census and number it among this
    thread's calls on ``g`` since its last backward (the same number on
    every member: they make the same calls on it)."""
    _count(name)
    calls = _tape().calls
    calls[id(g)] = call = calls.get(id(g), 0) + 1
    return call


def _record(kind, group, call, perm, items, out) -> Tuple[torch.Tensor, ...]:
    tape = _tape()
    out = tuple(_leaf(t, tape) if _is_float(t) else t for t in out)
    tape.entries.append(_Entry(
        kind, group, call, tuple(perm),
        tuple(t if _is_float(t) else None for t in items),
        tuple(t if _is_float(t) else None for t in out),
    ))
    return out


# ------------------------------------------------------------- the forwards


def ppermute(x: Any, group: Any, perm: Sequence[Tuple[int, int]]) -> Any:
    """Send ``x`` (a tensor or a tuple of tensors, moved as one hop) from
    each source to its destination in ``perm``, a list of ``(src, dst)``
    axis indices. Returns what this rank receives: zeros where no pair
    targets it, a copy where it is its own source."""
    kind, g = _resolve(group)
    _check_perm(perm, axis_size(group))
    call = _begin_call("ppermute", g)
    items = x if isinstance(x, tuple) else (x,)
    if kind == "thread":
        got = g.exchange_tensors((tuple(t.detach() for t in items), _wants_grad(items)))
        record = any(flag for _, flag in got)
        out = _permute_thread(items, [sent for sent, _ in got], g.rank, perm)
    else:
        record = _wants_grad(items)
        out = _permute_dist(items, items, g, perm)
    if record:
        out = _record("ppermute", group, call, perm, items, out)
    return out if isinstance(x, tuple) else out[0]


def _permute_thread(items, got, me, perm):
    """What rank ``me`` holds after a permute of the ranks' ``got``:
    zeros (like its own ``items``) when no pair targets it."""
    src_of = {d: s for s, d in perm}
    if me not in src_of:
        return tuple(torch.zeros_like(t) for t in items)
    if src_of[me] == me:
        return tuple(t.detach().clone() for t in items)
    return tuple(got[src_of[me]])


def _permute_dist(sends, like, g, perm):
    """One ``batch_isend_irecv`` along ``perm``: this rank's ``sends`` go
    to its destination, and what arrives from its source is shaped like
    ``like`` (zeros when no pair targets this rank, a copy of ``sends``
    for a self-pair). ``None`` items neither go nor come."""
    me = dist.get_rank(g)
    src_of = {d: s for s, d in perm}
    dst_of = {s: d for s, d in perm}
    if src_of.get(me) == me:
        out = tuple(None if t is None else t.detach().clone() for t in sends)
    else:
        out = tuple(None if t is None else
                    torch.zeros_like(t, memory_format=torch.contiguous_format)
                    for t in like)
    ops: List[dist.P2POp] = []
    if me in dst_of and dst_of[me] != me:
        peer = dist.get_global_rank(g, dst_of[me]) if g is not None else dst_of[me]
        ops += [dist.P2POp(dist.isend, t.detach().contiguous(), peer, g)
                for t in sends if t is not None]
    if me in src_of and src_of[me] != me:
        peer = dist.get_global_rank(g, src_of[me]) if g is not None else src_of[me]
        out = tuple(None if t is None else
                    torch.empty_like(t, memory_format=torch.contiguous_format)
                    for t in like)
        ops += [dist.P2POp(dist.irecv, t, peer, g) for t in out if t is not None]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def all_to_all(x: torch.Tensor, group: Any) -> torch.Tensor:
    """``lax.all_to_all(x, axis, 0, 0, tiled=True)``: split dim 0 into one
    block a rank, send block ``j`` to rank ``j``, and concatenate what
    arrives on dim 0 in source order."""
    kind, g = _resolve(group)
    size = axis_size(group)
    if x.shape[0] % size:
        raise ValueError(f"all_to_all: dim 0 ({x.shape[0]}) not divisible by {size} ranks")
    call = _begin_call("all_to_all", g)
    if kind == "thread":
        got = g.exchange_tensors((x.detach(), _wants_grad((x,))))
        record = any(flag for _, flag in got)
        out = torch.cat([blocks.chunk(size)[g.rank] for blocks, _ in got])
    else:
        record = _wants_grad((x,))
        out = _all_to_all_dist(x, g)
    if record:
        (out,) = _record("all_to_all", group, call, (), (x,), (out,))
    return out


def _all_to_all_dist(x: torch.Tensor, g: Any) -> torch.Tensor:
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, x.detach().contiguous(), group=g)
    return out


def psum(x: torch.Tensor, group: Any) -> torch.Tensor:
    """The sum of ``x`` over the axis, on every rank (ranks added in
    order on a thread group)."""
    kind, g = _resolve(group)
    call = _begin_call("psum", g)
    if kind == "thread":
        got = g.exchange_tensors((x.detach(), _wants_grad((x,))))
        record = any(flag for _, flag in got)
        out = _sum_in_order([part for part, _ in got], x.device)
    else:
        record = _wants_grad((x,))
        out = x.detach().clone()
        dist.all_reduce(out, group=g)
    if record:
        (out,) = _record("psum", group, call, (), (x,), (out,))
    return out


def _sum_in_order(parts: Sequence[Optional[torch.Tensor]], device) -> Optional[torch.Tensor]:
    """The parts added in rank order; ``None`` (no cotangent) adds
    nothing, and all ``None`` is ``None``."""
    total = None
    for part in parts:
        if part is not None:
            total = part.to(device, copy=True) if total is None else total + part.to(device)
    return total


# ------------------------------------------------------------ the backwards


def _ppermute_bwd(entry: _Entry, cts):
    """The cotangents of what this rank received go back to its source;
    what comes back from its destination is the cotangent of what it
    sent (``None`` with no destination)."""
    kind, g = _resolve(entry.group)
    dst = dict(entry.perm).get(axis_index(entry.group))
    if kind == "thread":
        got = g.exchange_tensors(cts)
        back = None if dst is None else got[dst]
    else:
        reverse = [(d, s) for s, d in entry.perm]
        back = _permute_dist(_zeros_for_none(cts, entry.received), entry.sent, g, reverse)
    return (None,) * len(cts) if dst is None else tuple(back)


def _all_to_all_bwd(entry: _Entry, cts):
    (ct,) = cts
    kind, g = _resolve(entry.group)
    size = axis_size(entry.group)
    if kind == "thread":
        got = g.exchange_tensors(ct)
        if all(c is None for c in got):
            return (None,)
        (sent,) = entry.sent
        return (torch.cat([
            torch.zeros_like(block) if c is None else c.chunk(size)[g.rank]
            for block, c in zip(sent.chunk(size), got)
        ]),)
    return (_all_to_all_dist(_zeros_for_none(cts, entry.received)[0], g),)


def _psum_bwd(entry: _Entry, cts):
    (ct,) = cts
    kind, g = _resolve(entry.group)
    (sent,) = entry.sent
    if kind == "thread":
        return (_sum_in_order(g.exchange_tensors(ct), sent.device),)
    out = _zeros_for_none(cts, entry.received)[0].clone()
    dist.all_reduce(out, group=g)
    return (out,)


def _zeros_for_none(cts, like):
    """A ``torch.distributed`` collective moves a tensor from every rank:
    zeros where no gradient reached a received leaf."""
    return tuple(None if r is None else (torch.zeros_like(r) if c is None else c)
                 for c, r in zip(cts, like))


_BACKWARD = {"ppermute": _ppermute_bwd, "all_to_all": _all_to_all_bwd, "psum": _psum_bwd}


def _reach(tensors, bits, memo) -> int:
    """The OR of ``bits`` (an autograd node's mask) over the nodes that a
    gradient of ``tensors`` flows through; ``memo`` keeps each node's."""
    starts = [get_gradient_edge(t).node for t in tensors if t is not None and t.requires_grad]
    stack = list(starts)
    while stack:
        node = stack[-1]
        if node in memo:
            stack.pop()
            continue
        children = [c for c, _ in node.next_functions if c is not None]
        todo = [c for c in children if c not in memo]
        if todo:
            stack.extend(todo)
            continue
        stack.pop()
        mask = bits.get(node, 0)
        for c in children:
            mask |= memo[c]
        memo[node] = mask
    mask = 0
    for node in starts:
        mask |= memo[node]
    return mask


def _gather_object(group: Any, obj: Any) -> List[Any]:
    kind, g = _resolve(group)
    if kind == "thread":
        with gather_transport():  # counted as ``backward_plan``
            return g.allgather_object(obj)
    out: List[Any] = [None] * dist.get_world_size(g)
    dist.all_gather_object(out, obj, group=g)
    return out


def _needed(entries: List[_Entry], roots: Sequence[torch.Tensor]) -> List[_Entry]:
    """The entries a backward from ``roots`` runs: those whose received
    values reach a loss on some rank of their group, there or through
    the sent values of a later entry that runs. Each rank's reachability
    (entry ``i`` is bit ``i``) is gathered once on the group, so every
    rank keeps the same entries. A tape on several groups keeps all."""
    if not entries or len({id(_resolve(e.group)[1]) for e in entries}) > 1:
        return entries
    bits = {get_gradient_edge(r).node: 1 << i
            for i, e in enumerate(entries) for r in e.received if r is not None}
    memo: dict = {}
    calls = [e.call for e in entries]
    mine = (calls, _reach(roots, bits, memo), [_reach(e.sent, bits, memo) for e in entries])
    del bits, memo
    _count("backward_plan")
    views = _gather_object(entries[0].group, mine)
    if any(theirs != calls for theirs, _, _ in views):
        raise RuntimeError(
            "backward: the ranks recorded different calls of the group "
            f"({[theirs for theirs, _, _ in views]}); on a torch.distributed "
            "group a rank records a call when one of its float items requires grad")
    live = 0
    for _, reached, _ in views:
        live |= reached
    for i in reversed(range(len(entries))):  # an entry's sent values reach only older ones
        if live >> i & 1:
            for _, _, deps in views:
                live |= deps[i]
    return [e for i, e in enumerate(entries) if live >> i & 1]


def backward(
    tensors: Union[torch.Tensor, Sequence[torch.Tensor]],
    grad_tensors: Union[None, torch.Tensor, Sequence[Optional[torch.Tensor]]] = None,
) -> None:
    """``torch.autograd.backward`` through this rank's program, the
    collectives this thread recorded included; every rank of every group
    those collectives ran on calls it, in lockstep (each recorded
    collective's backward is a collective). Gradients accumulate into the
    leaves' ``.grad`` as usual; the tape is consumed, entries that no
    rank's loss reads dropped without a collective."""
    tensors = (tensors,) if isinstance(tensors, torch.Tensor) else tuple(tensors)
    if grad_tensors is None or isinstance(grad_tensors, torch.Tensor):
        grad_tensors = (grad_tensors,) * len(tensors)
    tape = _tape()
    entries, tape.entries = tape.entries, []
    tape.calls.clear()
    roots = [(t, gt) for t, gt in zip(tensors, grad_tensors) if t.requires_grad]
    entries = _needed(entries, [t for t, _ in roots])
    tape.running = True
    try:
        if roots:
            torch.autograd.backward([t for t, _ in roots], [gt for _, gt in roots],
                                    retain_graph=bool(entries))
        while entries:
            entry = entries.pop()
            cts = tuple(None if r is None else r.grad for r in entry.received)
            _count(f"{entry.kind}_bwd")
            sent_cts = _BACKWARD[entry.kind](entry, cts)
            pairs = [(s, c) for s, c in zip(entry.sent, sent_cts)
                     if s is not None and c is not None and s.requires_grad]
            del entry, cts, sent_cts  # this step's cotangents, freed as it goes
            if pairs:
                torch.autograd.backward([s for s, _ in pairs], [c for _, c in pairs],
                                        retain_graph=True)
            del pairs
    finally:
        tape.running = False
