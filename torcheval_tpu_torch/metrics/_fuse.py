"""Run update plans: eagerly, or on CUDA as one CUDA-graph replay.

The one plan runner, for a lone ``Metric.update()`` and for
``toolkit.update_collection`` alike: :func:`prepare_plan` (the plan as an
``UpdatePlan``, bucketed) for each metric, then :func:`run_plans` (the
two groups, the donation and graph decision, the run, the states written
back, each ``finalize``).

Counterpart of ``torcheval_tpu/metrics/_fuse.py`` (``fused_accumulate``,
``fused_transform``, ``fused_accumulate_group``, with the JAX signatures
less ``out_shardings``). The JAX package jits each plan, or each panel of
plans, into one XLA program; here:

- **Eager** (every plan on the CPU; every plan when donation is off; an
  unbucketed group whose signature is new, too large or over its budget,
  below): ``states += kernel(*dynamic, *config)``, or
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
  reads back to the host. Other tensor inputs are copied in whole. The
  graph writes the new states into the metrics' live state tensors in
  place. Capture and replay never fall back: a failure raises.
- **Graphed when repeated** (``graph=REPEATED``: the unbucketed group of
  ``toolkit.update_collection`` on CUDA under donation): the same graph,
  keyed the same way with the plain inputs' shapes and dtypes, taken only
  where it pays. A group runs eagerly, counted in ``graph_stats()`` by
  reason, while its signature is on its first sighting
  (``eager_first_sighting``: one-off ragged shapes, and a kernel that is
  a fresh closure every call, never repeat), while the tensors a replay
  would copy in total more than ``REPEATED_INPUT_CAP_BYTES``
  (``eager_over_bytes``), once its set of states has used
  ``REPEATED_CAPTURE_BUDGET`` captures (``eager_budget``), and for good
  once its capture failed (``eager_capture_failed``; that call runs
  eagerly and nothing raises). A group the graph cannot take at all -- a
  state or input off the states' device, an unhashable constant, a state
  whose update changes its dtype or shape -- runs eagerly as
  ``eager_unfit``. On the second sighting the group is captured and
  replayed, as a bucketed one is. The same kernels run in the same order
  on the same stream, so the states come out as eager ones do.

Graph bookkeeping. A graph is keyed on its states' identities, so two
metrics never share one; the graphs of one set of states (a metric, or a
panel's metrics) share one memory pool, which is safe because their
replays are serial on one stream and nothing allocated inside a capture
outlives its replay (states and static inputs are allocated outside it).
When a state tensor dies (``reset`` without donation, ``load_state_dict``,
``to``, a dropped metric) every graph that writes it is dropped
(``weakref.finalize``), so no graph writes a freed buffer; so are the
sightings and the capture budget of its set of states. The first call
of a capture runs the kernels once on a side stream without writing any
state (the warm-up ``torch.cuda.graph`` asks for; a transform kernel gets
copies of the states), captures, then replays. If that warm-up finds a
state whose update would change its dtype or shape, the call runs eagerly
instead and nothing is captured; its next call has new state shapes, so a
new signature. Not thread-safe: one thread updates a metric at a time.

Kernel launch counts (``ops._kernels.LAUNCHES``) stay one a launch that
updates a state: the warm-up's launches and the capture's (which run
nothing) are held out, and every replay adds the launches the warm-up
made, so K1 counts one launch a streaming update whether it ran eagerly or
inside a replay.

Each capture is counted as the port's compile event
(``utils.compile_counter.note_capture``: ``CompileCounter`` and the
observability recorder's ``CompileEvent``), after the capture has ended,
with its host seconds and its bucket length (0 for an unbucketed group).
"""

from __future__ import annotations

import threading
import time
import warnings
import weakref
from typing import Any, Callable, Dict, List, Sequence, Set, Tuple

import torch

from torcheval_tpu_torch.metrics._bucket import Padded, ValidSizes, apply_bucketing, materialize
from torcheval_tpu_torch.metrics.metric import as_update_plan
from torcheval_tpu_torch.obs import trace as _obs_trace
from torcheval_tpu_torch.ops import _kernels
from torcheval_tpu_torch.utils import compile_counter

# ``graph=REPEATED``: graph a group once its signature repeats (module
# docstring), for the unbucketed group of ``toolkit.update_collection``
REPEATED = "repeated"
# The most a replay of a REPEATED group copies into its static inputs.
# 16 MiB takes ~10 us at the H100's 3.35 TB/s, under the host time one
# replay saves over eager plans; a larger batch is device-bound anyway,
# and copying it every call would cost device time and a second buffer
# of its size (an LM panel's logits: 0.8 GB).
REPEATED_INPUT_CAP_BYTES = 16 << 20
# Captures of REPEATED groups one set of states may make over its life;
# past them its new signatures run eagerly, so ragged unbucketed traffic
# cannot capture without end (shape bucketing is its answer, as in the
# JAX package).
REPEATED_CAPTURE_BUDGET = 8
# first sightings remembered per set of states, oldest dropped first
_SIGHTINGS_KEPT = 32


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
        torch.promote_types(state.dtype, out.dtype) == state.dtype
        and torch.broadcast_shapes(state.shape, out.shape) == state.shape
    )


def _add(state, out):
    """``state + out`` promoted by dtype alone, as JAX promotes: torch's
    own rule lets a dimensioned float16 operand outrank a 0-d float32
    state, which would narrow the state to float16."""
    if isinstance(state, torch.Tensor) and isinstance(out, torch.Tensor):
        dtype = torch.promote_types(state.dtype, out.dtype)
        return state.to(dtype) + out.to(dtype)
    return state + out


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
            new.append(o if transform else _add(s, o))
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


def fused_accumulate_group(plans, *, donate=False, graph=False, labels=None) -> tuple:
    """Run many plans -- ``(kernel, states, dynamic, config)`` or
    ``(kernel, states, dynamic, config, transform)`` tuples -- and return
    their new states, one tuple a plan. Eagerly, the plans run in turn;
    with ``graph=True`` the whole group is ONE CUDA-graph replay, the
    port's counterpart of the JAX package's one XLA program a panel; with
    ``graph=REPEATED`` it is one once its signature repeats, and eager
    until then (module docstring). ``donate`` covers every plan's states
    at once; a graph implies it.

    ``labels`` (one name a plan, its metric's class; ``update_collection``
    passes them while the recorder is on) traces the group: each eager
    plan runs inside a ``torcheval.accumulate/<label>`` span, a graphed
    group's replay inside one ``torcheval.replay`` span."""
    norm = [
        (p[0], tuple(p[1]), tuple(p[2]), tuple(p[3]), bool(p[4]) if len(p) > 4 else False)
        for p in plans
    ]
    traced = labels is not None
    if graph:
        out = _graphed(norm, traced, repeated=graph == REPEATED)
        if out is not None:
            return out
        donate = True
    out = []
    for i, (kernel, states, dynamic, config, transform) in enumerate(norm):
        with _obs_trace.scope_or_null("torcheval.accumulate", traced, labels[i] if traced else None):
            out.append(_eager(kernel, states, dynamic, config, transform, donate))
    return tuple(out)


def prepare_plan(metric, plan, pad_cache=None):
    """Step one of running a metric's update plan: the plan as an
    ``UpdatePlan`` (``metric.as_update_plan``), rewritten for its shape
    bucket (``_bucket.apply_bucketing``, which rejects labels that
    disagree), as a member ``(metric, plan, bucketed)`` for
    :func:`run_plans`; ``None`` for no plan. Nothing runs and no state
    changes, so a panel prepares every member before it runs any."""
    plan = as_update_plan(plan, metric)
    if plan is None:
        return None
    rewritten = apply_bucketing(plan, pad_cache)
    return metric, rewritten, rewritten is not plan


def run_plans(members, *, repeat_graphs: bool, traced: bool = False) -> None:
    """Step two: run prepared members in two groups, the unbucketed one
    first (a metric without a masked kernel cannot make the bucketed
    group's shape follow a ragged batch), write each metric's new states
    and call its plan's ``finalize``. A group of CUDA metrics under
    donation is one CUDA-graph replay when bucketed; when unbucketed it is
    one once its signature repeats, where ``repeat_graphs`` allows it
    (``graph=REPEATED``), and eager otherwise. ``traced`` opens the spans
    of :func:`fused_accumulate_group`."""
    for bucketed in (False, True):
        group = [(m, p) for m, p, b in members if b == bucketed]
        if not group:
            continue
        metrics = [m for m, _ in group]
        donate = all(m._donation_active() for m in metrics)
        graph = donate and graphed_update_possible(metrics) and (
            bucketed or (repeat_graphs and REPEATED)
        )
        new_states = fused_accumulate_group(
            [(p.kernel, tuple(getattr(m, n) for n in p.state_names), p.dynamic, p.config,
              p.transform) for m, p in group],
            donate=donate,
            graph=graph,
            labels=[type(m).__name__ for m in metrics] if traced else None,
        )
        for (metric, plan), states in zip(group, new_states):
            for name, value in zip(plan.state_names, states):
                setattr(metric, name, value)
            if plan.finalize is not None:
                plan.finalize()


# ------------------------------------------------------------ CUDA graphs


# Captures run one at a time in the process, and a captured graph dies
# under the same lock: torch registers each capture with the device's
# default CUDA generator and unregisters it as the graph dies, neither
# thread-safe, and ranks emulated as threads capture and drop graphs at once.
_CAPTURE_LOCK = threading.RLock()  # tev: disable=bare-lock -- serializes torch's CUDA generator registry (captures, graph deaths), not Python state


class _Graph:
    """One captured signature: the graph, its static input buffers, what
    the fill needs (each pad slot's filled extents, each valid slot's
    one-element views) and the kernel launches a replay runs."""

    __slots__ = (
        "graph", "statics", "extents", "valid_views", "copies", "state_ids", "pool_key",
        "launches",
    )

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
        # the slots copied in whole, and their statics (one foreach copy)
        self.copies = [i for i, o in enumerate(objs) if not isinstance(o, (Padded, ValidSizes))]
        self.state_ids = state_ids
        self.pool_key = pool_key
        self.launches: Dict[str, int] = {}

    def __del__(self, _lock=_CAPTURE_LOCK) -> None:
        with _lock:
            self.graph = None


class _Sightings:
    """A set of states' REPEATED signatures: those seen once (oldest
    first), those whose capture failed, and the captures tried."""

    __slots__ = ("seen", "failed", "captures")

    def __init__(self) -> None:
        self.seen: Dict[Any, None] = {}
        self.failed: Set[Any] = set()
        self.captures = 0


# the device type whose states a graphed update takes (the CPU tests
# emulate the graph on "cpu", with ``_record`` and ``torch.cuda`` faked)
_GRAPH_DEVICE_TYPE = "cuda"

# The tables below are keyed per set of states, and one thread updates a
# metric at a time, so threads touch disjoint entries; each dict operation
# is atomic under the GIL. _CAPTURE_LOCK guards torch's registry, not these.
_GRAPHS: Dict[Any, _Graph] = {}  # tev: disable=unguarded-state -- entries per set of states, one thread a metric
_SIGHTINGS: Dict[Any, _Sightings] = {}  # tev: disable=unguarded-state -- pool key -> its REPEATED signatures; entries per set of states
_BY_STATE: Dict[int, Set[Any]] = {}  # tev: disable=unguarded-state -- id(state tensor) -> graph and sightings keys; entries per state
_POOLS: Dict[Any, List[Any]] = {}  # tev: disable=unguarded-state -- pool key -> [handle, live graphs]; entries per set of states
_SIDE_STREAMS: Dict[int, "torch.cuda.Stream"] = {}  # tev: disable=unguarded-state -- written only inside a capture, under _CAPTURE_LOCK
# REPEATED groups that ran eagerly, by reason (module docstring)
_EAGER_REASONS = ("first_sighting", "over_bytes", "budget", "capture_failed", "unfit")
_STATS = dict(captures=0, replays=0, **{f"eager_{r}": 0 for r in _EAGER_REASONS})  # tev: disable=unguarded-state -- diagnostic counts: panels updated from threads at once may lose an increment, never a result


def graph_stats() -> Dict[str, int]:
    """Process-wide counts: graphs captured and replayed so far, REPEATED
    groups run eagerly by reason (``eager_<reason>``), and graphs and
    memory pools alive now."""
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
    return ("copy", obj.shape, obj.dtype)


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
    stream; no host sync): the plain tensors in one foreach copy."""
    if entry.copies:
        torch._foreach_copy_(
            [entry.statics[i] for i in entry.copies], [objs[i] for i in entry.copies]
        )
        if len(entry.copies) == len(objs):
            return
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
        if _SIGHTINGS.pop(key, None) is not None:
            _unwatch(key, key[1])
        return
    _unwatch(key, entry.state_ids)
    pool = _POOLS.get(entry.pool_key)
    if pool is not None:
        pool[1] -= 1
        if pool[1] == 0:
            del _POOLS[entry.pool_key]


def _watch(key, states) -> None:
    """Drop ``key`` (a graph's, or a set of states' sightings) when any
    of ``states`` dies."""
    for s in states:
        keys = _BY_STATE.get(id(s))
        if keys is None:
            keys = _BY_STATE[id(s)] = set()
            weakref.finalize(s, _forget_state, id(s))
        keys.add(key)


def _unwatch(key, state_ids) -> None:
    for sid in state_ids:
        keys = _BY_STATE.get(sid)
        if keys is not None:
            keys.discard(key)


def _register(key, entry: _Graph, states) -> None:
    _GRAPHS[key] = entry
    _watch(key, states)


def _decline(reason: str) -> None:
    """Count a REPEATED group that runs eagerly; the caller runs it."""
    _STATS["eager_" + reason] += 1


def _sighting(key, pool_key, states) -> str:
    """Whether a REPEATED signature not captured yet is captured now:
    ``""``, or the reason it runs eagerly. A capture is charged to its
    set of states' budget here."""
    seen = _SIGHTINGS.get(pool_key)
    if seen is None:
        seen = _SIGHTINGS[pool_key] = _Sightings()
        _watch(pool_key, states)
    if key in seen.failed:
        return "capture_failed"
    if key not in seen.seen:
        seen.seen[key] = None
        if len(seen.seen) > _SIGHTINGS_KEPT:
            del seen.seen[next(iter(seen.seen))]
        return "first_sighting"
    if seen.captures >= REPEATED_CAPTURE_BUDGET:
        return "budget"
    del seen.seen[key]
    seen.captures += 1
    return ""


def _stream_id(index: int) -> int:
    """The current stream of device ``index`` (its raw handle)."""
    return torch._C._cuda_getCurrentRawStream(index)


def _graph_device_index(states):
    """The device index all ``states`` share, if they are tensors on a
    device of ``_GRAPH_DEVICE_TYPE``; else None."""
    first = states[0] if states else None
    if not isinstance(first, torch.Tensor) or first.device.type != _GRAPH_DEVICE_TYPE:
        return None
    index = first.get_device()
    if all(isinstance(s, torch.Tensor) and s.get_device() == index for s in states):
        return index
    return None


def _graphed(plans, traced: bool = False, repeated: bool = False):
    """The group as one replay: its new states (the live ones, written in
    place), or None where it runs eagerly instead (the caller runs it)."""
    states = [s for _, st, _, _, _ in plans for s in st]
    index = _graph_device_index(states)
    if index is None:
        if repeated:
            return _decline("unfit")
        raise ValueError("a graphed update needs CUDA tensor states")
    device = states[0].device
    objs, arg_sig = _slots(plans)
    if repeated:
        copied = 0
        for o in objs:
            if not isinstance(o, torch.Tensor) or o.get_device() != index:
                return _decline("unfit")
            copied += o.nbytes
        if copied > REPEATED_INPUT_CAP_BYTES:
            return _decline("over_bytes")
    state_sig = tuple((id(s), s.data_ptr(), s.shape, s.dtype) for s in states)
    key = (
        index,
        _stream_id(index),
        tuple(p[0] for p in plans),
        tuple(p[3] for p in plans),
        tuple(p[4] for p in plans),
        tuple(len(p[1]) for p in plans),
        arg_sig,
        tuple(_slot_sig(o) for o in objs),
        state_sig,
    )
    try:
        entry = _GRAPHS.get(key)
    except TypeError:  # an unhashable constant or config
        if repeated:
            return _decline("unfit")
        raise
    captured = entry is None
    if captured:
        pool_key = (index, tuple(id(s) for s in states))
        if repeated:
            reason = _sighting(key, pool_key, states)
            if reason:
                return _decline(reason)
        try:
            entry = _capture(key, plans, objs, arg_sig, states, device, pool_key)
        except Exception as e:  # noqa: BLE001 -- a REPEATED call and signature run eagerly
            if not repeated:
                raise
            _SIGHTINGS[pool_key].failed.add(key)
            warnings.warn(
                "CUDA-graph capture of an unbucketed update failed "
                f"({', '.join(getattr(p[0], '__name__', str(p[0])) for p in plans)}: "
                f"{e.__cause__ or e!r}); its signature runs eagerly from now on",
                RuntimeWarning,
                stacklevel=2,
            )
            return _decline("capture_failed")
        if entry is None:  # a state changes dtype or shape: eager, once
            return _decline("unfit") if repeated else None
    with _obs_trace.scope_or_null("torcheval.replay", traced):
        if not captured:  # a capture filled the static inputs itself
            _fill(entry, objs)
        entry.graph.replay()
    if entry.launches:
        _kernels.add_launches(entry.launches)
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
            _end_generator_capture()
    return error


def _end_generator_capture() -> None:
    """A ``capture_end`` that raised (a capture a host sync broke) stopped
    before the CUDA generators' capture epilogue: the device's default
    generator still reads as capturing, and every later random draw on it
    would raise. A one-op capture that ends clears the mark (the
    generator's seed and offset are left as they were)."""
    mark = torch.zeros(1, device=torch.cuda.current_device())
    graph = torch.cuda.CUDAGraph()
    graph.capture_begin(capture_error_mode="thread_local")
    mark.add_(1)
    graph.capture_end()


def _capture(key, plans, objs, arg_sig, states, device, pool_key):
    with _CAPTURE_LOCK:
        return _capture_locked(key, plans, objs, arg_sig, states, device, pool_key)


def _capture_locked(key, plans, objs, arg_sig, states, device, pool_key):
    t0 = time.monotonic()
    stream = torch.cuda.current_stream(device)
    statics = [_alloc(o, device) for o in objs]
    entry = _Graph(statics, objs, tuple(id(s) for s in states), pool_key)
    _fill(entry, objs)
    static_plans = [
        (kernel, st, tuple(statics[a] if isinstance(a, int) else a[1] for a in row), config, transform)
        for (kernel, st, _, config, transform), row in zip(plans, arg_sig)
    ]
    side = _side_stream(device)
    side.wait_stream(stream)
    try:
        with torch.cuda.device(device), torch.cuda.stream(side):
            # warm-up: every kernel once, writing no state; its launches
            # are what each replay adds to the launch counts
            with _kernels.held_launches() as entry.launches:
                for kernel, st, dyn, config, transform in static_plans:
                    probe = tuple(s.clone() for s in st) if transform else st
                    outs = _outputs(kernel, config, probe, dyn, transform)
                    if not all(_in_place_ok(s, o, transform) for s, o in zip(st, outs)):
                        return None
            pool = _POOLS.get(pool_key)
            if pool is None:
                pool = _POOLS[pool_key] = [torch.cuda.graph_pool_handle(), 0]

            def body():
                for kernel, st, dyn, config, transform in static_plans:
                    _apply(st, _outputs(kernel, config, st, dyn, transform), transform, True)

            with _kernels.held_launches():  # a capture runs nothing
                error = _record(entry.graph, pool[0], body)
    finally:
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
    # the port's compile event (utils/compile_counter.py): counted and
    # handed to the sinks after the capture has ended, never inside it
    compile_counter.note_capture(
        time.monotonic() - t0,
        max((o.bucket for o in objs if isinstance(o, ValidSizes)), default=0),
    )
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
