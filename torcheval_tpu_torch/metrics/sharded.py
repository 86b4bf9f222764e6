"""In-step metric state sync over a ``torch.distributed`` process group.

Counterpart of ``torcheval_tpu/metrics/sharded.py`` with the same names.
The JAX package syncs metric states INSIDE a jitted, ``shard_map``-ped
step: ``lax.psum``/``pmax``/``pmin``/``all_gather`` fused into the
program. Here the step is eager, one process a device, and the same
declarative ``MergeKind`` metadata drives one ``torch.distributed``
collective per kind and dtype, on the device tensors themselves (gloo on
the CPU, NCCL on the card):

- ``SUM`` -> ``all_reduce(SUM)``; ``MAX``/``MIN`` -> ``all_reduce(MAX/
  MIN)``; same-kind, same-dtype states are flattened into ONE buffer, so
  a collection syncs in a handful of collectives;
- ``EXTEND`` -> ``all_gather_into_tensor`` of the local buffer (its
  valid prefix when ``extend_valid`` bounds it), flattened along the
  example axis in rank order;
- ``shard_specs`` -> ``reduce_scatter_tensor``: an owner-partitioned SUM
  state's local value is the full-size delta, and each rank receives the
  global sum of its own ``size/world`` block.

``axis_name`` (a mesh axis or a tuple of them) becomes ``group``: a
``torch.distributed`` ``ProcessGroup``, the port's ``MultiHostGroup``
(its communicator), or ``None`` for the default group. On the card a
collective that fails raises; nothing moves to the CPU.

The lossy wire rungs (``compression="bf16"``/``"int8"``) narrow EXTEND
gathers and owner-partitioned reduce-scatters of float payloads over 1
KiB, as the JAX package's do. ``bf16`` casts the payload across the
collective and back. ``int8`` quantizes blockwise on the device
(``wire.quantize_blockwise_jit``) and bit-packs codes and scales into one
uint8 tensor: ``_quantized_gather`` is one uint8 ``all_gather_into_tensor``
in place of the float one, and ``_quantized_reduce_scatter`` packs one
block an owner, exchanges them in one ``all_to_all_single`` and sums the
dequantized blocks it receives. No collective is added; integer payloads
and the SUM/MAX/MIN all-reduces stay exact.

Typical use::

    specs = state_merge_specs(MulticlassAccuracy(device=dev))
    step = donated_sync_step(lambda x, y: {"num_correct": ..., "num_total": ...},
                             group, specs)
    carry = {"num_correct": torch.zeros(...), "num_total": torch.zeros(...)}
    for x, y in loader:
        carry = step(carry, x, y)   # synced totals, updated in place
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from torcheval_tpu_torch import wire as wirelib
from torcheval_tpu_torch.metrics.metric import MergeKind, Metric
from torcheval_tpu_torch.metrics.shardspec import ShardSpec

__all__ = ["donated_sync_step", "state_merge_specs", "sync_states_in_jit", "tree_add"]

_REDUCE_OPS = {
    MergeKind.SUM: dist.ReduceOp.SUM,
    MergeKind.MAX: dist.ReduceOp.MAX,
    MergeKind.MIN: dist.ReduceOp.MIN,
}


def state_merge_specs(metric: Metric) -> Dict[str, MergeKind]:
    """The declarative merge kinds registered by ``_add_state``."""
    return dict(metric._state_name_to_merge_kind)


def _pow2_cover(n: int) -> int:
    """Smallest power of two >= ``n`` (>= 1): the trim bucket."""
    n = int(n)
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def _torch_group(group):
    """The ``torch.distributed`` communicator of ``group``: a
    ``MultiHostGroup`` (or a wrapper of one) gives its own; a
    ``ProcessGroup`` or ``None`` (the default group) is used as is."""
    unwrap = getattr(group, "unwrap", None)
    if unwrap is not None:
        group = unwrap()
        if not hasattr(group, "_group"):
            raise TypeError(
                f"{type(group).__name__} has no torch.distributed communicator; "
                "sync_states_in_jit runs over a process group"
            )
        return group._group
    return group


def _check_compression(compression: Optional[str]) -> str:
    """The rung named by ``compression`` (``None``: the configured
    default-family rung, read when the step is built or called)."""
    from torcheval_tpu_torch import config

    if compression is None:
        compression = config.sync_compression()
    if compression not in ("off", "exact", "bf16", "int8"):
        raise ValueError(f"unknown compression rung {compression!r}")
    return compression


# the lossy rungs leave small payloads alone, as the eager wire does
# (synclib._BF16_MIN_BYTES/_INT8_MIN_BYTES)
_LOSSY_MIN_BYTES = 1024


def _wants_lossy(value: torch.Tensor, compression: str) -> bool:
    return (
        compression in ("bf16", "int8")
        and value.is_floating_point()
        and value.dtype != torch.bfloat16
        and value.numel() * value.element_size() > _LOSSY_MIN_BYTES
    )


def _quantized_gather(value: torch.Tensor, pg, world: int, block: int) -> torch.Tensor:
    """EXTEND gather at the int8 rung: quantize the (already trimmed)
    local buffer blockwise, bit-pack codes and scales into one uint8
    tensor, gather that in one ``all_gather_into_tensor``, and unpack and
    dequantize each rank's row. Returns ``(world,) + value.shape``."""
    q, scales = wirelib.quantize_blockwise_jit(value, block)
    wire = wirelib.pack_wire(q, scales)
    gathered = torch.empty((world * wire.numel(),), dtype=torch.uint8, device=wire.device)
    _deprecated_quietly(dist.all_gather_into_tensor, gathered, wire, group=pg)
    rows = gathered.reshape(world, wire.numel())
    nb = scales.numel()
    deq = torch.stack([wirelib.unpack_wire(row, nb, block) for row in rows])
    deq = deq[:, : value.numel()].to(value.dtype)
    return deq.reshape((world,) + tuple(value.shape))


def _quantized_reduce_scatter(
    value: torch.Tensor, pg, world: int, spec_axis: int, block: int
) -> torch.Tensor:
    """Owner-partitioned SUM at the int8 rung: cut the full-size local
    delta into one block an owner, quantize and bit-pack each, exchange
    them in one ``all_to_all_single`` (in place of the reduce-scatter),
    then dequantize the world's blocks for this owner and sum them in
    float32, in rank order."""
    delta = torch.movedim(value, spec_axis, 0)
    if delta.shape[0] % world:
        raise ValueError(
            f"owner-partitioned state of size {delta.shape[0]} along axis "
            f"{spec_axis} does not divide the world size {world}"
        )
    rest = tuple(delta.shape[1:])
    blocks = delta.reshape(world, -1)
    packed = []
    for b in blocks:
        q, scales = wirelib.quantize_blockwise_jit(b, block)
        packed.append(wirelib.pack_wire(q, scales))
    nb = scales.numel()
    wire = torch.stack(packed)
    exchanged = torch.empty_like(wire)
    dist.all_to_all_single(exchanged, wire, group=pg)
    deq = torch.stack([wirelib.unpack_wire(row, nb, block) for row in exchanged])
    deq = deq[:, : blocks.shape[1]]
    owned = deq.sum(dim=0, dtype=torch.float32).to(value.dtype)
    owned = owned.reshape((delta.shape[0] // world,) + rest)
    return torch.movedim(owned, 0, spec_axis)


def _deprecated_quietly(fn, *args, **kwargs):
    """Call a collective whose tensor form newer torch releases flag as
    deprecated (``all_gather_into_tensor``, ``reduce_scatter_tensor``):
    every supported release has it."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", category=FutureWarning, message=".*deprecated.*")
        return fn(*args, **kwargs)


def sync_states_in_jit(
    states: Dict[str, torch.Tensor],
    group=None,
    specs: Optional[Dict[str, MergeKind]] = None,
    *,
    extend_valid: Optional[Dict[str, int]] = None,
    compression: Optional[str] = None,
    shard_specs: Optional[Dict[str, ShardSpec]] = None,
) -> Dict[str, torch.Tensor]:
    """Merge per-rank metric states across ``group`` (module docstring).

    Args:
        states: ``{name: tensor}`` local states, on this rank's device.
        group: the process group (``None``: the default one).
        specs: merge kinds a state; SUM by default. CUSTOM raises: sync
            bespoke merges through the eager toolkit.
        extend_valid: ``{name: bound}`` valid-count bounds of EXTEND
            buffers (covering every rank's count): each is cut to the
            power of two covering its bound before the gather.
        compression: a wire rung (``"off"``/``"exact"`` | ``"bf16"`` |
            ``"int8"``) for float EXTEND and owner-partitioned payloads
            over 1 KiB (module docstring); ``None``: the configured
            default-family rung (``config.sync_compression()``), exact
            unless set.
        shard_specs: ``{name: ShardSpec}`` owner-partitioned SUM states:
            the local value is the full-size delta, and the result is
            this rank's ``size/world`` block of the global sum (one
            reduce-scatter). Other kinds raise.

    Returns new tensors; the inputs are not modified.
    """
    from torcheval_tpu_torch import config

    compression = _check_compression(compression)
    block = config.wire_block_size()
    pg = _torch_group(group)
    world = dist.get_world_size(pg)
    synced: Dict[str, torch.Tensor] = {}
    reduce_groups: Dict[Any, list] = {}  # (kind, dtype) -> [(name, value)]
    for name, value in states.items():
        kind = (specs or {}).get(name, MergeKind.SUM)
        spec = (shard_specs or {}).get(name)
        if spec is not None:
            if kind is not MergeKind.SUM:
                raise NotImplementedError(
                    f"owner-partitioned state {name!r} must be SUM-kind "
                    f"(got {kind}); MAX/MIN/EXTEND states have no "
                    "reduce-scatter lowering"
                )
            if compression == "int8" and _wants_lossy(value, compression):
                synced[name] = _quantized_reduce_scatter(value, pg, world, spec.axis, block)
                continue
            wire = value.to(torch.bfloat16) if _wants_lossy(value, compression) else value
            delta = torch.movedim(wire, spec.axis, 0).contiguous()
            if delta.shape[0] % world:
                raise ValueError(
                    f"owner-partitioned state of size {delta.shape[0]} along axis "
                    f"{spec.axis} does not divide the world size {world}"
                )
            owned = torch.empty(
                (delta.shape[0] // world,) + tuple(delta.shape[1:]),
                dtype=delta.dtype,
                device=delta.device,
            )
            _deprecated_quietly(dist.reduce_scatter_tensor, owned, delta, group=pg)
            synced[name] = torch.movedim(owned, 0, spec.axis).to(value.dtype)
        elif kind in _REDUCE_OPS:
            reduce_groups.setdefault((kind, value.dtype), []).append((name, value))
        elif kind is MergeKind.EXTEND:
            bound = (extend_valid or {}).get(name)
            if bound is not None:
                value = value[: min(_pow2_cover(bound), value.shape[0])]
            value = value.contiguous()
            if compression == "int8" and _wants_lossy(value, compression):
                # trim first (above), then quantize the trimmed payload
                gathered = _quantized_gather(value, pg, world, block)
                synced[name] = gathered.reshape((-1,) + tuple(value.shape[1:]))
                continue
            wire = value.to(torch.bfloat16) if _wants_lossy(value, compression) else value
            gathered = torch.empty(
                (world * wire.shape[0],) + tuple(wire.shape[1:]),
                dtype=wire.dtype,
                device=wire.device,
            )
            _deprecated_quietly(dist.all_gather_into_tensor, gathered, wire, group=pg)
            synced[name] = gathered.to(value.dtype)
        else:
            raise NotImplementedError(
                f"State {name!r} has merge kind {kind}; custom merges must "
                "use the eager toolkit sync."
            )
    for (kind, _dtype), members in reduce_groups.items():
        flat = torch.cat([v.reshape(-1) for _, v in members])
        dist.all_reduce(flat, op=_REDUCE_OPS[kind], group=pg)
        offset = 0
        for name, value in members:
            synced[name] = flat[offset : offset + value.numel()].reshape(value.shape)
            offset += value.numel()
    return synced


def tree_add(state: Dict[str, Any], delta: Dict[str, Any]) -> Dict[str, Any]:
    """Accumulate an update's counter deltas into the carried state."""
    return {name: state[name] + delta[name] for name in state}


def donated_sync_step(
    update_fn,
    group=None,
    specs: Optional[Dict[str, MergeKind]] = None,
    *,
    compression: Optional[str] = None,
    shard_specs: Optional[Dict[str, ShardSpec]] = None,
):
    """The carried-state eval step with the carry DONATED: returns
    ``step(state, *batch) -> state`` that syncs ``update_fn(*batch)``'s
    LOCAL deltas (re-syncing the already-synced carry would multiply SUM
    counters by the world size) and folds them into the carry's own
    tensors in place, by merge kind. The same dict comes back.

    ``specs``: SUM/MAX/MIN only (an EXTEND gather grows by the world size
    and cannot land in the carry's tensor). ``shard_specs``: SUM states
    whose carry is this rank's ``size/world`` block; each step's
    full-size delta reduce-scatters onto it. There is no ``mesh`` or
    ``batch_specs``: each process feeds its own batch.

    Ownership, as for every donated path: the carry's tensors are written
    in place; seed it with fresh tensors (a template metric's
    ``state_dict()``), not ones something else still reads.
    """
    reduce_kinds = (MergeKind.SUM, MergeKind.MAX, MergeKind.MIN)
    for name, kind in (specs or {}).items():
        if kind not in reduce_kinds:
            raise NotImplementedError(
                f"donated_sync_step supports only reduce merge kinds "
                f"(SUM/MAX/MIN); state {name!r} has {kind}. EXTEND "
                "buffers grow by the world size per gather, so their "
                "sync output can never alias the donated carry."
            )
    for name in shard_specs or {}:
        kind = (specs or {}).get(name, MergeKind.SUM)
        if kind is not MergeKind.SUM:
            raise NotImplementedError(
                f"owner-partitioned carry state {name!r} must be SUM-kind (got {kind})"
            )
    _check_compression(compression)

    def step(state, *batch):
        synced = sync_states_in_jit(
            update_fn(*batch),
            group,
            specs,
            compression=compression,
            shard_specs=shard_specs or None,
        )
        for name, value in synced.items():
            kind = (specs or {}).get(name, MergeKind.SUM)
            carry = state[name]
            if kind is MergeKind.SUM:
                carry.add_(value)
            elif kind is MergeKind.MAX:
                torch.maximum(carry, value, out=carry)
            else:
                torch.minimum(carry, value, out=carry)
        return state

    return step
