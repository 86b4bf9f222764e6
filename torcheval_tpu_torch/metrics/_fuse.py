"""Run update plans: eagerly, or on CUDA as one CUDA-graph replay.

Counterpart of ``torcheval_tpu/metrics/_fuse.py`` (``fused_accumulate``,
``fused_transform``, ``fused_accumulate_group``, with the JAX signatures
less ``out_shardings``). The JAX package jits each plan, or each panel of
plans, into one XLA program; here:

- **Eager** (every plan on the CPU; unbucketed plans on CUDA; bucketed
  ones when donation is off): ``states += kernel(*dynamic, *config)``, or
  ``states = kernel(states, *dynamic, *config)`` for a transform plan, as
  plain torch ops. With ``donate=True`` the new state is written into the
  old tensor (``add_`` / ``copy_``) wherever that keeps its dtype and
  shape -- XLA aliases only matching buffers too -- and is a new tensor
  otherwise (a scalar state meeting its first 2-D batch).
- **Graphed** (``graph=True``: bucket-rewritten plans of CUDA metrics
  under donation): one CUDA graph per signature -- the kernels, configs,
  transform flags, the bucket shapes and dtypes of the inputs, and the
  identities of the live state tensors -- captured on the signature's
  first call and replayed after it. The padded inputs and the valid
  vector are the graph's static input buffers: each call copies its batch
  into them (zeroing only what the previous batch left past the new
  extents) and fills the valid extents with one fill a slot, so nothing
  reads back to the host. The graph writes the new states into the
  metrics' live state tensors in place. Capture and replay never fall
  back: a failure raises.

Graph bookkeeping. A graph is keyed on its states' identities, so two
metrics never share one; the graphs of one set of states (a metric, or a
panel's metrics) share one memory pool, which is safe because their
replays are serial on one stream and nothing allocated inside a capture
outlives its replay (states and static inputs are allocated outside it).
When a state tensor dies (``reset`` without donation, ``load_state_dict``,
``to``, a dropped metric) every graph that writes it is dropped
(``weakref.finalize``), so no graph writes a freed buffer. The first call
of a signature runs the kernels once on a side stream without writing any
state (the warm-up ``torch.cuda.graph`` asks for; a transform kernel gets
copies of the states), captures, then replays. If that warm-up finds a
state whose update would change its dtype or shape, the call runs eagerly
instead and nothing is captured; its next call has new state shapes, so a
new signature. Not thread-safe: one thread updates a metric at a time.
"""

from __future__ import annotations

import weakref
from typing import Any, Callable, Dict, List, Sequence, Set, Tuple

import torch

from torcheval_tpu_torch.metrics._bucket import Padded, ValidSizes, materialize


def _check_arity(kernel, out, states):
    """Normalize a kernel's output to a tuple and require one entry per
    state -- zip-assignment would otherwise silently truncate."""
    if not isinstance(out, tuple):
        out = (out,)
    if len(out) != len(states):
        raise ValueError(
            f"kernel {getattr(kernel, '__name__', kernel)} returned "
            f"{len(out)} values for {len(states)} states"
        )
    return out


def _outputs(kernel, config, states, dyn, transform):
    if transform:
        return _check_arity(kernel, kernel(states, *dyn, *config), states)
    return _check_arity(kernel, kernel(*dyn, *config), states)


def _in_place_ok(state, out, transform: bool) -> bool:
    """Whether ``state`` can take its new value in place, keeping its
    dtype and shape (``s + d`` for an accumulate, ``out`` for a transform)."""
    if not isinstance(state, torch.Tensor) or not isinstance(out, torch.Tensor):
        return False
    if transform:
        return out.dtype == state.dtype and out.shape == state.shape
    return (
        torch.result_type(state, out) == state.dtype
        and torch.broadcast_shapes(state.shape, out.shape) == state.shape
    )


def _apply(states, outs, transform: bool, donate: bool) -> tuple:
    new = []
    for s, o in zip(states, outs):
        if transform and o is s:
            new.append(s)
        elif donate and _in_place_ok(s, o, transform):
            if transform:
                s.copy_(o)
            else:
                s.add_(o)
            new.append(s)
        else:
            new.append(o if transform else s + o)
    return tuple(new)


def _eager(kernel, states, dynamic, config, transform: bool, donate: bool) -> tuple:
    dyn = tuple(materialize(a) for a in dynamic)
    return _apply(states, _outputs(kernel, config, states, dyn, transform), transform, donate)


def fused_accumulate(
    kernel: Callable,
    states: Tuple[torch.Tensor, ...],
    dynamic: Tuple[Any, ...],
    config: Tuple = (),
    *,
    donate: bool = False,
    graph: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """``tuple(s + d for s, d in zip(states, kernel(*dynamic, *config)))``.

    ``kernel`` may return one tensor (a 1-tuple) or a tuple matching
    ``states``. ``donate=True`` adds in place where the sum keeps the
    state's dtype and shape. ``graph=True`` (CUDA states; implies
    donation) runs the update as a CUDA-graph replay; see the module
    docstring. Returns the new states (the same tensors where in place).
    """
    return fused_accumulate_group(
        [(kernel, states, dynamic, config, False)], donate=donate, graph=graph
    )[0]


def fused_transform(
    kernel, states, dynamic, config=(), *, donate=False, graph=False
) -> Tuple[torch.Tensor, ...]:
    """``kernel(states, *dynamic, *config)`` -> new states, the
    non-additive sibling of :func:`fused_accumulate` (ring column writes,
    running extrema, the K1 histogram); ``donate`` and ``graph`` as
    there."""
    return fused_accumulate_group(
        [(kernel, states, dynamic, config, True)], donate=donate, graph=graph
    )[0]


def fused_accumulate_group(plans, *, donate=False, graph=False) -> tuple:
    """Run many plans -- ``(kernel, states, dynamic, config)`` or
    ``(kernel, states, dynamic, config, transform)`` tuples -- and return
    their new states, one tuple a plan. Eagerly, the plans run in turn;
    with ``graph=True`` the whole group is ONE CUDA-graph replay, the
    port's counterpart of the JAX package's one XLA program a panel.
    ``donate`` covers every plan's states at once."""
    norm = [
        (p[0], tuple(p[1]), tuple(p[2]), tuple(p[3]), bool(p[4]) if len(p) > 4 else False)
        for p in plans
    ]
    if graph:
        return _graphed(norm)
    return tuple(
        _eager(kernel, states, dynamic, config, transform, donate)
        for kernel, states, dynamic, config, transform in norm
    )


# ------------------------------------------------------------ CUDA graphs


class _Graph:
    """One captured signature: the graph, its static input buffers and
    what the fill needs (each pad slot's filled extents, each valid slot's
    one-element views)."""

    __slots__ = ("graph", "statics", "extents", "valid_views", "state_ids", "pool_key")

    def __init__(self, statics, objs, state_ids, pool_key) -> None:
        self.graph = torch.cuda.CUDAGraph()
        self.statics = statics
        self.extents: List[Any] = [
            (0,) * s.ndim if isinstance(o, Padded) else None for s, o in zip(statics, objs)
        ]
        self.valid_views = [
            [s[i : i + 1] for i in range(s.shape[0])] if isinstance(o, ValidSizes) else None
            for s, o in zip(statics, objs)
        ]
        self.state_ids = state_ids
        self.pool_key = pool_key


# the device type whose states a graphed update takes (the CPU tests
# emulate the graph on "cpu", with ``_record`` and ``torch.cuda`` faked)
_GRAPH_DEVICE_TYPE = "cuda"

_GRAPHS: Dict[Any, _Graph] = {}
_BY_STATE: Dict[int, Set[Any]] = {}  # id(state tensor) -> graph keys
_POOLS: Dict[Any, List[Any]] = {}  # pool key -> [handle, live graphs]
_SIDE_STREAMS: Dict[int, "torch.cuda.Stream"] = {}
_STATS = {"captures": 0, "replays": 0}


def graph_stats() -> Dict[str, int]:
    """Process-wide counts: graphs captured and replayed so far, graphs
    and memory pools alive now."""
    return dict(_STATS, graphs=len(_GRAPHS), pools=len(_POOLS))


def graph_pools() -> List[Any]:
    """The live memory-pool handles of the captured graphs (one a set of
    states), for reading their reserved bytes off a memory snapshot."""
    return [entry[0] for entry in _POOLS.values()]


def _slots(plans) -> Tuple[list, tuple]:
    """The distinct input objects of a group (padded inputs, valid
    vectors, other tensors) and, per plan, each dynamic argument's slot
    index (or ``("const", value)`` for a non-tensor, baked into the key)."""
    index: Dict[int, int] = {}
    objs: list = []
    sig = []
    for _, _, dynamic, _, _ in plans:
        row = []
        for a in dynamic:
            if isinstance(a, (Padded, ValidSizes, torch.Tensor)):
                i = index.get(id(a))
                if i is None:
                    i = index[id(a)] = len(objs)
                    objs.append(a)
                row.append(i)
            else:
                row.append(("const", a))
        sig.append(tuple(row))
    return objs, tuple(sig)


def _slot_sig(obj) -> tuple:
    if isinstance(obj, Padded):
        return ("pad", obj.shape, obj.source.dtype)
    if isinstance(obj, ValidSizes):
        return ("valid", len(obj.sizes))
    return ("copy", tuple(obj.shape), obj.dtype)


def _alloc(obj, device) -> torch.Tensor:
    if isinstance(obj, Padded):
        return torch.zeros(obj.shape, dtype=obj.source.dtype, device=device)
    if isinstance(obj, ValidSizes):
        return torch.zeros(len(obj.sizes), dtype=torch.int32, device=device)
    return torch.empty_like(obj, device=device)


def _zero_outside(static: torch.Tensor, old: tuple, new: tuple) -> None:
    """Zero the region ``[0, old)`` leaves outside ``[0, new)``, one slab
    an axis (the points whose first axis past ``new`` is that axis)."""
    for axis in range(len(old)):
        if new[axis] >= old[axis]:
            continue
        region = tuple(
            slice(0, min(o, n)) if j < axis
            else slice(new[axis], old[axis]) if j == axis
            else slice(0, o)
            for j, (o, n) in enumerate(zip(old, new))
        )
        static[region].zero_()


def _fill(entry: _Graph, objs) -> None:
    """Copy this call's inputs into the static buffers (on the current
    stream; no host sync)."""
    for i, obj in enumerate(objs):
        static = entry.statics[i]
        if isinstance(obj, Padded):
            src = obj.source
            new = tuple(src.shape)
            _zero_outside(static, entry.extents[i], new)
            if new == tuple(static.shape):
                static.copy_(src)
            else:
                static[tuple(slice(0, n) for n in new)].copy_(src)
            entry.extents[i] = new
        elif isinstance(obj, ValidSizes):
            for view, n in zip(entry.valid_views[i], obj.sizes):
                view.fill_(n)
        else:
            static.copy_(obj)


def _side_stream(device) -> "torch.cuda.Stream":
    stream = _SIDE_STREAMS.get(device.index)
    if stream is None:
        stream = _SIDE_STREAMS[device.index] = torch.cuda.Stream(device)
    return stream


def _forget_state(state_id: int) -> None:
    for key in _BY_STATE.pop(state_id, ()):
        _evict(key)


def _evict(key) -> None:
    entry = _GRAPHS.pop(key, None)
    if entry is None:
        return
    for sid in entry.state_ids:
        keys = _BY_STATE.get(sid)
        if keys is not None:
            keys.discard(key)
    pool = _POOLS.get(entry.pool_key)
    if pool is not None:
        pool[1] -= 1
        if pool[1] == 0:
            del _POOLS[entry.pool_key]


def _register(key, entry: _Graph, states) -> None:
    _GRAPHS[key] = entry
    for s in states:
        keys = _BY_STATE.get(id(s))
        if keys is None:
            keys = _BY_STATE[id(s)] = set()
            weakref.finalize(s, _forget_state, id(s))
        keys.add(key)


def _graphed(plans) -> tuple:
    states = [s for _, st, _, _, _ in plans for s in st]
    if not states or not all(
        isinstance(s, torch.Tensor) and s.device.type == _GRAPH_DEVICE_TYPE for s in states
    ):
        raise ValueError("a graphed update needs CUDA tensor states")
    device = states[0].device
    stream = torch.cuda.current_stream(device)
    objs, arg_sig = _slots(plans)
    state_sig = tuple((id(s), s.data_ptr(), tuple(s.shape), s.dtype) for s in states)
    key = (
        device.index,
        stream.cuda_stream,
        tuple(p[0] for p in plans),
        tuple(p[3] for p in plans),
        tuple(p[4] for p in plans),
        tuple(len(p[1]) for p in plans),
        arg_sig,
        tuple(_slot_sig(o) for o in objs),
        state_sig,
    )
    entry = _GRAPHS.get(key)
    if entry is None:
        entry = _capture(key, plans, objs, arg_sig, states, device, stream)
        if entry is None:  # a state changes dtype or shape: eager, once
            return tuple(
                _eager(kernel, st, dynamic, config, transform, True)
                for kernel, st, dynamic, config, transform in plans
            )
    else:
        _fill(entry, objs)
    entry.graph.replay()
    _STATS["replays"] += 1
    return tuple(st for _, st, _, _, _ in plans)


def _record(graph, pool, body):
    """Capture ``body`` into ``graph`` in ``pool``; returns the exception
    that broke the capture, or ``None``."""
    error = None
    graph.capture_begin(pool=pool, capture_error_mode="thread_local")
    try:
        body()
    except Exception as e:  # returned, once the capture has ended
        error = e
    finally:
        try:
            graph.capture_end()
        except RuntimeError as e:
            error = error or e
    return error


def _capture(key, plans, objs, arg_sig, states, device, stream):
    statics = [_alloc(o, device) for o in objs]
    pool_key = (device.index, tuple(id(s) for s in states))
    entry = _Graph(statics, objs, tuple(id(s) for s in states), pool_key)
    _fill(entry, objs)
    static_plans = [
        (kernel, st, tuple(statics[a] if isinstance(a, int) else a[1] for a in row), config, transform)
        for (kernel, st, _, config, transform), row in zip(plans, arg_sig)
    ]
    side = _side_stream(device)
    side.wait_stream(stream)
    with torch.cuda.device(device), torch.cuda.stream(side):
        # warm-up: every kernel once, writing no state
        for kernel, st, dyn, config, transform in static_plans:
            probe = tuple(s.clone() for s in st) if transform else st
            outs = _outputs(kernel, config, probe, dyn, transform)
            if not all(_in_place_ok(s, o, transform) for s, o in zip(st, outs)):
                stream.wait_stream(side)
                return None
        pool = _POOLS.get(pool_key)
        if pool is None:
            pool = _POOLS[pool_key] = [torch.cuda.graph_pool_handle(), 0]

        def body():
            for kernel, st, dyn, config, transform in static_plans:
                _apply(st, _outputs(kernel, config, st, dyn, transform), transform, True)

        error = _record(entry.graph, pool[0], body)
    # the static buffers outlive the side stream's reads of them
    stream.wait_stream(side)
    if error is not None:
        if pool[1] == 0:
            del _POOLS[pool_key]
        raise RuntimeError(
            "CUDA-graph capture of a bucketed update failed "
            f"({', '.join(getattr(p[0], '__name__', str(p[0])) for p in plans)})"
        ) from error
    pool[1] += 1
    _STATS["captures"] += 1
    _register(key, entry, states)
    return entry


def graphed_update_possible(metrics: Sequence[Any]) -> bool:
    """Whether a group of metrics may run its bucketed plans as one
    graph: every metric on the same CUDA device, with donation active."""
    devices = {m.device for m in metrics}
    return (
        len(devices) == 1
        and next(iter(devices)).type == _GRAPH_DEVICE_TYPE
        and all(m._donation_active() for m in metrics)
    )
