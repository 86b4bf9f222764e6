"""Sharded metric state: each rank keeps a slice of a big state.

Counterpart of ``torcheval_tpu/metrics/shardspec.py`` with the same public
names. A state registered with ``Metric._add_state(..., shard=ShardSpec(0))``
on a metric built with ``shard=ShardContext(rank, world)`` lives as this
rank's contiguous slice of axis 0, so per-rank state bytes drop to
``size/world``:

- **Routed counter states** (:func:`enable_routing`, the confusion matrix
  and ``HistogramBinnedAUROC``): an update scatters the batch's OWNED
  cells into the local shard and appends the flat indices of the FOREIGN
  ones to an int32 outbox at a device-side cursor; a sync ships the shard
  plus the outbox trimmed to its power-of-two cover, and the merge
  (``Metric._merge_sharded``) reassembles the logical state from every
  rank's slice before applying every outbox in rank order. Integer adds
  commute, so the synced state equals the replicated merge bitwise.
- **Routed float states** (:func:`enable_value_routing`, the row form of
  ``WeightedCalibration``): the outbox also carries each foreign row's
  float32 payloads and one boundary a batch, so the merge folds each
  batch as one segment sum and adds the batch sums in stream order, the
  replicated metric's addition order.
- **Owner-partitioned states** (the windows' task rings): every rank sees
  the same update stream and keeps only its rows; the sync places
  disjoint rows, with no reduction at all.

**The mesh form.** The JAX package's ``ShardContext.from_mesh`` is a single
controller: one process holds every device's shard of one logical array
(``NamedSharding``), and its fused updates pin ``out_shardings`` so XLA
keeps the state distributed. PyTorch runs one process a card, and has no
such array to hold. Here :meth:`ShardContext.from_mesh` takes a
``torch.distributed.device_mesh.DeviceMesh`` and an axis name and returns
the EAGER context of this process's coordinate on that axis; ``is_mesh``
is always False, and ``_fuse`` has no ``out_shardings``.

**The outbox cursor.** The JAX package writes foreign indices with
``lax.dynamic_update_slice`` at the cursor, which clamps its start. Here
the write is ``index_copy_`` at ``cursor + arange(width)``: the cursor is
read on the device, so a bucketed update is one CUDA-graph replay with no
host sync, and :func:`ensure_outbox_capacity` reserves the whole (padded)
width on the host, so the write never runs past the end. Growing an
outbox swaps its tensor, and a CUDA graph is keyed on its states'
identities, so each growth step captures anew; pre-size the outbox
(``ensure_outbox_capacity(metric, state, n)``) to keep a ragged stream at
its bucket bound.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

__all__ = [
    "ShardContext",
    "ShardSpec",
    "ShardInfo",
    "enable_routing",
    "enable_value_routing",
    "ht_scale",
    "route_scatter_kernel",
    "route_scatter_kernel_masked",
    "route_scatter_values_kernel",
    "route_scatter_values_kernel_masked",
]

_OUTBOX_MIN_CAPACITY = 64


class ShardSpec(NamedTuple):
    """Per-state sharding declaration (``Metric._add_state(shard=...)``):
    ``axis`` is the state dimension partitioned across the world. It must
    divide evenly by the world size.

    >>> from torcheval_tpu_torch.metrics import ShardSpec
    >>> ShardSpec(axis=0)
    ShardSpec(axis=0)
    """

    axis: int = 0


class ShardInfo(NamedTuple):
    """Registered bookkeeping for one sharded state."""

    spec: ShardSpec
    logical_shape: Tuple[int, ...]
    dtype: Any
    sharding: Any = None  # the JAX package's NamedSharding; always None here

    @property
    def logical_size(self) -> int:
        size = 1
        for d in self.logical_shape:
            size *= int(d)
        return size


class ShardContext:
    """Which shard of a metric's sharded states this process holds:
    ``ShardContext(rank, world)``, or built from a process group
    (:meth:`from_group`) or a device mesh axis (:meth:`from_mesh`).

    >>> from torcheval_tpu_torch.metrics import MulticlassConfusionMatrix, ShardContext
    >>> cm = MulticlassConfusionMatrix(8, shard=ShardContext(rank=1, world=4), device="cpu")
    >>> tuple(cm.confusion_matrix.shape)  # this rank's slice, not (8, 8)
    (2, 8)
    """

    def __init__(self, rank: int, world: int) -> None:
        world = int(world)
        rank = int(rank)
        if world < 1:
            raise ValueError(f"shard world must be >= 1, got {world}")
        if not 0 <= rank < world:
            raise ValueError(f"shard rank {rank} out of range for world {world}")
        self.rank = rank
        self.world = world
        self.mesh = None
        self.mesh_axis: Optional[str] = None

    @classmethod
    def from_group(cls, group) -> "ShardContext":
        """The context of a ``ProcessGroup``'s rank and world."""
        return cls(group.rank, group.world_size)

    @classmethod
    def from_mesh(cls, mesh, axis: str = "dp") -> "ShardContext":
        """The eager context of this process's coordinate on ``axis`` of a
        ``torch.distributed.device_mesh.DeviceMesh`` (see the module
        docstring: torch has no single-controller mesh array)."""
        dim = list(mesh.mesh_dim_names or ()).index(axis)
        ctx = cls(mesh.get_local_rank(dim), mesh.size(dim))
        ctx.mesh_axis = axis
        return ctx

    @property
    def is_mesh(self) -> bool:
        """Always False: every context of the port is eager."""
        return False

    # a context is configuration, not state: clones and deep copies of a
    # metric share it
    def __deepcopy__(self, memo) -> "ShardContext":
        return self

    def __copy__(self) -> "ShardContext":
        return self

    def shard_range(
        self, dim: int, rank: Optional[int] = None, world: Optional[int] = None
    ) -> Tuple[int, int]:
        """Contiguous ``[start, stop)`` owned along a sharded dimension."""
        world = self.world if world is None else int(world)
        rank = self.rank if rank is None else int(rank)
        dim = int(dim)
        if dim % world != 0:
            raise ValueError(
                f"sharded dimension {dim} does not divide evenly over "
                f"world {world}; size the metric configuration (classes/"
                "bins/tasks) to a multiple of the shard world"
            )
        k = dim // world
        return rank * k, (rank + 1) * k

    def prepare_state(
        self, name: str, default, spec: ShardSpec
    ) -> Tuple[torch.Tensor, ShardInfo]:
        """The registered default (this rank's slice of the logical
        default) and the :class:`ShardInfo` of one sharded state."""
        if not isinstance(default, torch.Tensor):
            raise TypeError(
                f"sharded state {name!r} must register an array default, "
                f"got {type(default).__name__}"
            )
        axis = spec.axis
        if not 0 <= axis < default.ndim:
            raise ValueError(
                f"sharded state {name!r}: axis {axis} out of range for "
                f"shape {tuple(default.shape)}"
            )
        logical_shape = tuple(int(d) for d in default.shape)
        start, stop = self.shard_range(logical_shape[axis])
        shard_default = default.narrow(axis, start, stop - start).clone()
        return shard_default, ShardInfo(spec, logical_shape, default.dtype)


# ---------------------------------------------------------------- routing


class RoutedInfo(NamedTuple):
    """Outbox bookkeeping for one routed state.

    ``obi``: int32 buffer of foreign FLAT indices (``-1`` = dropped slot:
    an owned entry or an out-of-range index); ``obn``: int32 0-d device
    write cursor (advanced inside the update, so an update uploads
    nothing); ``obh``: its host int mirror (advanced by the plan's
    ``finalize``), for capacity growth and payload trimming.

    The float value lane (:func:`enable_value_routing`) adds ``obv``, the
    float32 ``(capacity, len(states))`` payloads, and ``obb``/``obc``/
    ``obbh``, the int32 batch-boundary buffer with its device and host
    cursors. ``states`` names the member states sharing the outbox.
    """

    state: str
    obi: str
    obn: str
    obh: str
    obv: Optional[str] = None
    obb: Optional[str] = None
    obc: Optional[str] = None
    obbh: Optional[str] = None
    states: Tuple[str, ...] = ()

    @property
    def is_value_lane(self) -> bool:
        return self.obv is not None


def routed_names(state: str) -> RoutedInfo:
    return RoutedInfo(state, f"{state}__obi", f"{state}__obn", f"{state}__obh")


def value_routed_names(states: Tuple[str, ...]) -> RoutedInfo:
    primary = states[0]
    return RoutedInfo(
        primary,
        f"{primary}__obi",
        f"{primary}__obn",
        f"{primary}__obh",
        obv=f"{primary}__obv",
        obb=f"{primary}__obb",
        obc=f"{primary}__obc",
        obbh=f"{primary}__obbh",
        states=tuple(states),
    )


def _empty_index() -> torch.Tensor:
    return torch.zeros((0,), dtype=torch.int32)


def _zero_cursor() -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32)


def _empty_values(k: int) -> torch.Tensor:
    return torch.zeros((0, k), dtype=torch.float32)


def enable_routing(metric, state: str) -> Optional[RoutedInfo]:
    """Register the outbox states of one sharded counter state; call right
    after its ``_add_state(..., shard=ShardSpec(...))``. ``None`` (and
    nothing registered) unless the metric has a shard context.

    World 1 registers them too, so its snapshots interchange with those of
    larger worlds; its updates stay on the dense plans
    (``Metric._route_active``)."""
    from torcheval_tpu_torch.metrics.metric import MergeKind

    ctx = metric._shard_ctx
    if ctx is None or state not in metric._sharded_states:
        return None
    info = metric._sharded_states[state]
    if info.logical_size >= 2**31:
        raise ValueError(
            f"routed state {state!r} has {info.logical_size} logical "
            "cells; flat routing indices must fit int32"
        )
    names = routed_names(state)
    metric._add_state(names.obi, _empty_index(), merge=MergeKind.CUSTOM)
    metric._add_state(names.obn, _zero_cursor(), merge=MergeKind.CUSTOM)
    metric._add_state(names.obh, 0, merge=MergeKind.CUSTOM)
    metric._routed_states[state] = names
    return names


def enable_value_routing(metric, states) -> Optional[RoutedInfo]:
    """Register one shared float-payload outbox for a group of sharded
    float32 states fed by the same row stream; call right after the
    members' ``_add_state(..., shard=...)``. ``None`` unless the metric has
    a shard context."""
    from torcheval_tpu_torch.metrics.metric import MergeKind

    states = tuple(states)
    ctx = metric._shard_ctx
    if ctx is None or not all(s in metric._sharded_states for s in states):
        return None
    info = metric._sharded_states[states[0]]
    if info.logical_size >= 2**31:
        raise ValueError(
            f"routed state {states[0]!r} has {info.logical_size} logical "
            "cells; flat routing indices must fit int32"
        )
    names = value_routed_names(states)
    metric._add_state(names.obi, _empty_index(), merge=MergeKind.CUSTOM)
    metric._add_state(names.obv, _empty_values(len(states)), merge=MergeKind.CUSTOM)
    metric._add_state(names.obn, _zero_cursor(), merge=MergeKind.CUSTOM)
    metric._add_state(names.obh, 0, merge=MergeKind.CUSTOM)
    metric._add_state(names.obb, _empty_index(), merge=MergeKind.CUSTOM)
    metric._add_state(names.obc, _zero_cursor(), merge=MergeKind.CUSTOM)
    metric._add_state(names.obbh, 0, merge=MergeKind.CUSTOM)
    for s in states:
        metric._routed_states[s] = names
    return names


def _outbox_capacity(n: int) -> int:
    if n <= _OUTBOX_MIN_CAPACITY:
        return _OUTBOX_MIN_CAPACITY
    return 1 << (n - 1).bit_length()


def _grown(buf: torch.Tensor, new_cap: int, fill) -> torch.Tensor:
    out = torch.full((new_cap,) + tuple(buf.shape[1:]), fill, dtype=buf.dtype, device=buf.device)
    out[: buf.shape[0]] = buf
    return out


def ensure_outbox_capacity(metric, state: str, n_new: int) -> None:
    """Grow an outbox (power of two, ``-1`` fill) to admit ``n_new`` more
    entries, from the host mirror of its cursor. Under shape bucketing the
    masked routed kernel writes the whole bucket at the cursor (the tail
    past the valid rows is ``-1`` scratch the next append overwrites), so
    the bucketed width is reserved."""
    from torcheval_tpu_torch import config

    names = metric._routed_states[state]
    buf = getattr(metric, names.obi)
    width = int(n_new)
    if config.shape_bucketing_enabled():
        from torcheval_tpu_torch.metrics._bucket import bucket_length

        width = bucket_length(width)
    needed = getattr(metric, names.obh) + width
    if needed > buf.shape[0]:
        new_cap = _outbox_capacity(needed)
        setattr(metric, names.obi, _grown(buf, new_cap, -1))
        if names.is_value_lane:
            setattr(metric, names.obv, _grown(getattr(metric, names.obv), new_cap, 0.0))
    if names.is_value_lane:
        # one boundary slot a batch: the host mirror advances by one per
        # finalize, so this capacity is exact
        bbuf = getattr(metric, names.obb)
        bneeded = getattr(metric, names.obbh) + 1
        if bneeded > bbuf.shape[0]:
            setattr(metric, names.obb, _grown(bbuf, _outbox_capacity(bneeded), -1))


def _append(obi: torch.Tensor, obn: torch.Tensor, rows: torch.Tensor) -> None:
    """Write ``rows`` into ``obi`` at ``obn + arange(len(rows))``, reading
    the cursor on the device."""
    pos = obn.to(torch.int64) + torch.arange(rows.shape[0], device=obi.device)
    obi.index_copy_(0, pos, rows)


def _route_counts(shard, idx, start: int, stop: int):
    """Add the owned entries of ``idx`` into ``shard`` (flat, in place)
    and return the foreign ones (owned entries as ``-1``)."""
    owned = (idx >= start) & (idx < stop)
    local = torch.where(owned, idx - start, torch.zeros_like(idx)).to(torch.int64)
    shard.view(-1).index_add_(0, local, owned.to(shard.dtype))
    return torch.where(owned, torch.full_like(idx, -1), idx).to(torch.int32)


# one kernel object per (index_fn, range, config): a stable object keeps
# _fuse's graph keys steady across updates
_ROUTE_KERNEL_CACHE: Dict[Any, Any] = {}


def route_scatter_kernel(index_fn, start: int, stop: int, cfg: Tuple = ()):
    """The sharded scatter update of one routed counter state.

    ``index_fn(*dynamic, *cfg)`` maps a batch to logical flat cells
    (negative = dropped). The transform takes ``states = (shard, outbox,
    cursor)`` and the batch: it adds the owned cells
    (``start <= idx < stop``) into the shard in place, writes the batch's
    index vector with owned entries as ``-1`` into the outbox at the
    device cursor, and returns the cursor advanced by the batch length.
    Counts are integers, so the in-place add equals the JAX package's
    ``shard + segment_count(...)`` bitwise."""
    key = (index_fn, int(start), int(stop), cfg)
    fn = _ROUTE_KERNEL_CACHE.get(key)
    if fn is not None:
        return fn
    start, stop = int(start), int(stop)

    def transform(states, *dynamic):
        shard, obi, obn = states
        idx = index_fn(*dynamic, *cfg).to(torch.int64)
        foreign = _route_counts(shard, idx, start, stop)
        _append(obi, obn, foreign)
        return shard, obi, obn + idx.shape[0]

    _ROUTE_KERNEL_CACHE[key] = transform
    return transform


def route_scatter_kernel_masked(index_fn, start: int, stop: int, cfg: Tuple = ()):
    """Mask-aware twin of :func:`route_scatter_kernel` (shape bucketing):
    ``transform(states, *padded_dynamic, valid)``. Padded rows (position
    ``>= valid[0]``) take the ``-1`` drop index, so they are neither owned
    nor foreign; the outbox write is the padded width and the cursor
    advances by ``valid[0]``, so the padded tail is scratch the next
    append overwrites and the device cursor stays equal to the host
    mirror."""
    key = (index_fn, int(start), int(stop), cfg, "masked")
    fn = _ROUTE_KERNEL_CACHE.get(key)
    if fn is not None:
        return fn
    start, stop = int(start), int(stop)

    def transform(states, *dynamic_and_valid):
        dynamic, valid = dynamic_and_valid[:-1], dynamic_and_valid[-1]
        shard, obi, obn = states
        idx = index_fn(*dynamic, *cfg).to(torch.int64)
        row_ok = torch.arange(idx.shape[0], device=idx.device) < valid[0]
        idx = torch.where(row_ok, idx, torch.full_like(idx, -1))
        foreign = _route_counts(shard, idx, start, stop)
        _append(obi, obn, foreign)
        return shard, obi, obn + valid[0]

    _ROUTE_KERNEL_CACHE[key] = transform
    return transform


def apply_outbox_counts(logical_flat: torch.Tensor, entries: torch.Tensor) -> torch.Tensor:
    """Add one rank's outbox entries (flat indices, ``-1`` = dropped) into
    a flat logical counter state, in place; returns it. Exact for the
    integer counters routing supports."""
    if entries.shape[0] == 0:
        return logical_flat
    size = logical_flat.shape[0]
    ids = entries.to(logical_flat.device).to(torch.int64)
    valid = (ids >= 0) & (ids < size)
    ids = torch.where(valid, ids, torch.zeros_like(ids))
    return logical_flat.index_add_(0, ids, valid.to(logical_flat.dtype))


def _route_values(shards, idx, vals, start: int, stop: int):
    """The float lane's shard update (a segment sum a member, then the add,
    as the JAX package orders it) and its outbox rows."""
    from torcheval_tpu_torch.ops import segment

    n_local = stop - start
    owned = (idx >= start) & (idx < stop)
    local = torch.where(owned, idx - start, torch.full_like(idx, n_local)).to(torch.int32)
    new_shards = tuple(
        (
            sh.reshape(-1)
            + segment.segment_sum(v.to(torch.float32), local, n_local + 1)[:n_local].to(sh.dtype)
        ).reshape(sh.shape)
        for sh, v in zip(shards, vals)
    )
    foreign = torch.where(owned, torch.full_like(idx, -1), idx).to(torch.int32)
    stacked = torch.stack([v.to(torch.float32) for v in vals], dim=-1)
    stacked = torch.where((foreign >= 0)[:, None], stacked, torch.zeros_like(stacked))
    return new_shards, foreign, stacked


def _value_transform(row_fn, start, stop, n_states, cfg, masked: bool):
    def transform(states, *args):
        dynamic, valid = (args[:-1], args[-1]) if masked else (args, None)
        shards = states[:n_states]
        obi, obv, obn, obb, obc = states[n_states:]
        idx, vals = row_fn(*dynamic, *cfg)
        idx = idx.to(torch.int64)
        if masked:
            row_ok = torch.arange(idx.shape[0], device=idx.device) < valid[0]
            idx = torch.where(row_ok, idx, torch.full_like(idx, -1))
        new_shards, foreign, stacked = _route_values(shards, idx, vals, start, stop)
        pos = obn.to(torch.int64) + torch.arange(idx.shape[0], device=obi.device)
        obi.index_copy_(0, pos, foreign)
        obv.index_copy_(0, pos, stacked)
        new_obn = obn + (valid[0] if masked else idx.shape[0])
        obb.index_copy_(0, obc.to(torch.int64).reshape(1), new_obn.reshape(1).to(obb.dtype))
        return new_shards + (obi, obv, new_obn, obb, obc + 1)

    return transform


def route_scatter_values_kernel(row_fn, start: int, stop: int, n_states: int, cfg: Tuple = ()):
    """Float-lane twin of :func:`route_scatter_kernel` for ``n_states``
    float32 states sharing one row stream.

    ``row_fn(*dynamic, *cfg) -> (idx, (v_0, ..., v_{n-1}))`` maps a batch
    to flat cells and one payload a member. The transform takes
    ``states = (shard_0, .., shard_{n-1}, outbox, payloads, cursor,
    bounds, bcursor)``: each member's owned payloads segment-summed into
    its shard, the foreign ``(idx, payloads)`` rows written at the cursor
    (owned rows as ``-1``/zero), and the post-batch cursor recorded as a
    batch boundary."""
    key = (row_fn, int(start), int(stop), int(n_states), cfg, "values")
    fn = _ROUTE_KERNEL_CACHE.get(key)
    if fn is None:
        fn = _ROUTE_KERNEL_CACHE[key] = _value_transform(
            row_fn, int(start), int(stop), int(n_states), cfg, False
        )
    return fn


def route_scatter_values_kernel_masked(
    row_fn, start: int, stop: int, n_states: int, cfg: Tuple = ()
):
    """Mask-aware twin of :func:`route_scatter_values_kernel`: padded rows
    take the ``-1`` index and zero payloads, the write is the padded
    width, and the cursor and boundary advance by ``valid[0]``."""
    key = (row_fn, int(start), int(stop), int(n_states), cfg, "values-masked")
    fn = _ROUTE_KERNEL_CACHE.get(key)
    if fn is None:
        fn = _ROUTE_KERNEL_CACHE[key] = _value_transform(
            row_fn, int(start), int(stop), int(n_states), cfg, True
        )
    return fn


def ht_scale(payload, inv_weight):
    """Horvitz-Thompson reweighting on the float value lane: every payload
    column times the row's inverse inclusion probability, so each
    accumulated (linear) column estimates its full-ingest value without
    bias."""
    w = inv_weight.to(torch.float32)
    return tuple(p.to(torch.float32) * w for p in payload)


def complete_bounds(bounds, cnt: int):
    """A recorded batch-boundary list made to cover ``cnt`` outbox
    entries: entries past the last boundary fold as one final batch. Every
    fold site completes bounds this way, so all fold the same batches."""
    out = [int(b) for b in bounds if int(b) <= int(cnt)]
    if not out or out[-1] != int(cnt):
        out.append(int(cnt))
    return out


def apply_outbox_values(
    logical_flat: torch.Tensor, entries: torch.Tensor, values: torch.Tensor, bounds
) -> torch.Tensor:
    """Fold one rank's float-lane outbox into a flat logical state one
    batch at a time, in stream order: each batch one segment sum, the
    batch sums added in turn, as the replicated metric added them.
    Returns a new tensor."""
    from torcheval_tpu_torch.ops import segment

    size = logical_flat.shape[0]
    out = logical_flat
    start = 0
    for stop in bounds:
        stop = int(stop)
        if stop <= start:
            continue
        ids = segment.safe_ids(entries[start:stop], size)
        out = out + segment.segment_sum(
            values[start:stop].to(torch.float32), ids, size
        ).to(out.dtype)
        start = stop
    return out
