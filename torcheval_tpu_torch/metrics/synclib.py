"""Tensor-level state sync primitives.

Counterpart of ``torcheval_tpu/metrics/synclib.py`` at the exact wire tier:
every rank's ``{metric_name: state_dict}`` is packed, in one deterministic
(alphabetical) traversal order, into one flat uint8 payload -- tensors raw,
or zero-suppressed (uint32 indices of the bit-nonzero elements plus their
values, lossless) when that at least halves a large state -- with shapes,
dtypes, encodings and scalar states riding the metadata. A collection
syncs in one metadata gather plus one payload gather, whatever the number
of metrics, over local replicas or over processes. A crc32 of each payload
rides the metadata and is checked on receipt. Each rank's shapes ride its
own metadata, so states of different shapes per rank (buffers of different
capacity) unpack.

Partial participation (``resilience.ResilientGroup``): the gathers use
the ``allgather_*_with_ranks`` protocol, so a degraded group can hand
back a subset of ranks. ``sync_states`` intersects the participants of
the two gathers (metadata and payload may lose different ranks), checks
each surviving payload against the crc32 riding the metadata, enforces
the quorum, and returns a :class:`SyncedStates` whose ``.ranks`` names
exactly the ranks that contributed. None of it costs a collective.

The lossy wire rungs (``torcheval_tpu_torch.wire``) ride the same
protocol: each metric's float arrays of at least 1 KiB are encoded at the
rung its family rides (``sync_states(families=...)`` resolves
``wire.effective_rung`` per metric), as a dense bfloat16 cast
(``("dense", "bfloat16")``), blockwise int8 (``("int8block", block,
nblocks, nexc)``) or the zero-suppressed indices followed by int8 values
(``("sparse8", nnz, block, nexc)``); integer arrays never quantize. The
packed bytes and metadata are the JAX package's, so either package
decodes the other's buffers. ``SyncedStates.wire_tiers`` names the rung
each metric's payload actually rode, and :func:`canonical_crc` checks what
a receiver merges (the bytes after dequantization) rather than what
travelled.
"""

from __future__ import annotations

import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from torcheval_tpu_torch import wire as wirelib
from torcheval_tpu_torch.distributed import LocalReplicaGroup, ProcessGroup
from torcheval_tpu_torch.resilience import (
    SyncIntegrityError,
    SyncTimeoutError,
    quorum_count,
)
from torcheval_tpu_torch.utils.convert import bfloat16_numpy_dtype, tensor_to_numpy

# {metric_name: {state_name: TState}}
MetricStates = Dict[str, Dict[str, Any]]

# (kind, [(shape, dtype, enc), ...], extra): kind "tensor" | "list" | "dict"
# | "obj"; extra carries the sorted dict keys, or the value itself for
# "obj". enc is the wire encoding of one array:
#   None                        raw bytes;
#   ("dense", wire_dtype)       the bf16 rung's cast (lossy);
#   ("sparse", nnz, wire_dtype) uint32 indices of the bit-nonzero elements
#                               plus their values (lossless);
#   ("int8block", block, nblocks, nexc)
#                               int8 codes padded to whole blocks, a float32
#                               scale a block, then the exact float32 values
#                               of the nexc non-finite elements;
#   ("sparse8", nnz, block, nexc)
#                               the sparse indices, then the nnz values at
#                               the int8 rung as above.
_StateMeta = Tuple[str, List[Tuple[Tuple[int, ...], str, Any]], Any]

# sparse pays for its nonzero scan only on payloads at least this large,
# and only when it at least halves the bytes
_SPARSE_MIN_BYTES = 4096
# the lossy rungs leave small payloads (counters) alone
_BF16_MIN_BYTES = 1024
_INT8_MIN_BYTES = 1024

_BIT_VIEWS = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}

# enc tag -> the rung it rides (sparse is lossless: exact)
_ENC_TIERS = {
    None: "exact",
    "sparse": "exact",
    "dense": "bf16",
    "int8block": "int8",
    "sparse8": "int8",
}


class SyncedStates(List[MetricStates]):
    """Per-rank gathered states plus partial-participation metadata.

    A plain list of the surviving ranks' states (ascending rank order),
    with:

    - ``ranks``: the ranks whose states are present, aligned with the list;
    - ``world_size``: the group's full world size;
    - ``degraded``: True when some rank did not contribute;
    - ``sent_bytes``/``recv_bytes``: the packed payload this rank shipped,
      and the surviving ranks' payloads combined (read off the metadata
      the protocol already exchanged);
    - ``wire_tiers``: ``{metric: rung}``, the lossiest encoding any
      surviving rank applied to the metric (``"exact"`` when every payload
      stayed raw or sparse).
    """

    ranks: Tuple[int, ...] = ()
    world_size: int = 0
    sent_bytes: int = 0
    recv_bytes: int = 0
    wire_tiers: Dict[str, str] = {}

    @property
    def degraded(self) -> bool:
        return len(self.ranks) < self.world_size


def metrics_traversal_order(metric_states: MetricStates) -> List[Tuple[str, str]]:
    """Deterministic (metric, state) visit order: the cross-rank ordering
    contract."""
    order: List[Tuple[str, str]] = []
    for metric_name in sorted(metric_states.keys()):
        for state_name in sorted(metric_states[metric_name].keys()):
            order.append((metric_name, state_name))
    return order


def _as_numpy(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return tensor_to_numpy(x)
    return np.asarray(x)


def _encode_array(
    a: np.ndarray, compression: str = "exact", block: int = 32
) -> Tuple[Tuple[Tuple[int, ...], str, Any], List[np.ndarray]]:
    """One array -> (meta entry, wire chunks) at the rung ``compression``
    (``exact``/``off`` | ``bf16`` | ``int8``); integer arrays never
    quantize. See ``_StateMeta``."""
    shape = tuple(a.shape)  # before ascontiguousarray, which makes 0-d 1-d
    dtype = str(a.dtype)
    is_float = a.dtype in (np.float32, np.float64)
    if compression == "int8" and is_float and a.nbytes >= _INT8_MIN_BYTES:
        flat = np.ascontiguousarray(a).reshape(-1)
        bits = _BIT_VIEWS[flat.dtype.itemsize]
        if flat.nbytes >= _SPARSE_MIN_BYTES and flat.size < 2**32:
            idx = np.flatnonzero(flat.view(bits))
            if idx.size * (4 + flat.dtype.itemsize) * 2 <= flat.nbytes:
                # trim first (lossless), then quantize what is left unless
                # int8 would not shrink it
                vals = np.ascontiguousarray(flat[idx])
                idx32 = idx.astype(np.uint32)
                exc = wirelib.nonfinite_exceptions(vals)
                if wirelib.int8_wire_bytes(idx.size, block) + 4 * exc.size < vals.nbytes:
                    q, scales = wirelib.quantize_blockwise(vals, block)
                    enc = ("sparse8", int(idx.size), int(block), int(exc.size))
                    return (shape, dtype, enc), [
                        idx32.view(np.uint8),
                        q.view(np.uint8),
                        scales.view(np.uint8),
                        exc.view(np.uint8),
                    ]
                enc = ("sparse", int(idx.size), str(flat.dtype))
                return (shape, dtype, enc), [idx32.view(np.uint8), vals.view(np.uint8)]
        # non-finite elements (neutral fills, NaN) ride as -128 sentinels
        # plus an exact side list; quantize only while that still wins
        exc = wirelib.nonfinite_exceptions(flat)
        if wirelib.int8_wire_bytes(flat.size, block) + 4 * exc.size < flat.nbytes:
            q, scales = wirelib.quantize_blockwise(flat, block)
            enc = ("int8block", int(block), int(scales.size), int(exc.size))
            return (shape, dtype, enc), [
                q.view(np.uint8),
                scales.view(np.uint8),
                exc.view(np.uint8),
            ]
    wire = a
    if compression == "bf16" and is_float and a.nbytes >= _BF16_MIN_BYTES:
        wire = a.astype(bfloat16_numpy_dtype())
    flat = np.ascontiguousarray(wire).reshape(-1)
    bits = _BIT_VIEWS.get(flat.dtype.itemsize)
    if bits is not None and flat.nbytes >= _SPARSE_MIN_BYTES and flat.size < 2**32:
        idx = np.flatnonzero(flat.view(bits))
        if idx.size * (4 + flat.dtype.itemsize) * 2 <= flat.nbytes:
            enc = ("sparse", int(idx.size), str(flat.dtype))
            return (shape, dtype, enc), [
                idx.astype(np.uint32).view(np.uint8),
                np.ascontiguousarray(flat[idx]).view(np.uint8),
            ]
    enc = None if wire is a else ("dense", str(flat.dtype))
    return (shape, dtype, enc), [flat.view(np.uint8)]


def _np_dtype(name: str) -> np.dtype:
    """A wire dtype by name (bfloat16 through ml_dtypes)."""
    return bfloat16_numpy_dtype() if name == "bfloat16" else np.dtype(name)


def _decode_array(buf: np.ndarray, offset: int, entry) -> Tuple[np.ndarray, int]:
    """Inverse of ``_encode_array`` for one gathered entry."""
    shape, dtype, enc = entry
    dtype = _np_dtype(dtype)
    size = int(np.prod(shape, dtype=np.int64))
    if enc is None:
        nbytes = size * dtype.itemsize
        return buf[offset : offset + nbytes].view(dtype).reshape(shape), offset + nbytes
    if enc[0] == "dense":
        wire_dtype = _np_dtype(enc[1])
        nbytes = size * wire_dtype.itemsize
        wire = buf[offset : offset + nbytes].view(wire_dtype)
        return wire.astype(dtype).reshape(shape), offset + nbytes
    if enc[0] == "sparse":
        _, nnz, wire_name = enc
        wire_dtype = _np_dtype(wire_name)
        idx = buf[offset : offset + nnz * 4].view(np.uint32)
        offset += nnz * 4
        vals = buf[offset : offset + nnz * wire_dtype.itemsize].view(wire_dtype)
        offset += nnz * wire_dtype.itemsize
        out = np.zeros(size, dtype=dtype)
        out[idx] = vals.astype(dtype)
        return out.reshape(shape), offset
    if enc[0] == "int8block":
        _, block, nblocks, nexc = enc
        q = buf[offset : offset + nblocks * block].view(np.int8)
        offset += nblocks * block
        scales = buf[offset : offset + 4 * nblocks].view(np.float32)
        offset += 4 * nblocks
        exc = buf[offset : offset + 4 * nexc].view(np.float32)
        offset += 4 * nexc
        out = wirelib.dequantize_blockwise(q, scales, size, dtype, exc)
        return out.reshape(shape), offset
    if enc[0] == "sparse8":
        _, nnz, block, nexc = enc
        idx = buf[offset : offset + nnz * 4].view(np.uint32)
        offset += nnz * 4
        nblocks = -(-max(nnz, 1) // block)
        q = buf[offset : offset + nblocks * block].view(np.int8)
        offset += nblocks * block
        scales = buf[offset : offset + 4 * nblocks].view(np.float32)
        offset += 4 * nblocks
        exc = buf[offset : offset + 4 * nexc].view(np.float32)
        offset += 4 * nexc
        out = np.zeros(size, dtype=dtype)
        out[idx] = wirelib.dequantize_blockwise(q, scales, nnz, dtype, exc)
        return out.reshape(shape), offset
    raise ValueError(f"unknown wire encoding {enc!r}")


def _pack_rank_states(
    metric_states: MetricStates,
    order: List[Tuple[str, str]],
    compression: Any = "exact",
) -> Tuple[List[_StateMeta], np.ndarray]:
    """Pack one rank's states, in traversal order, into (metadata, flat
    uint8 payload). ``compression`` is one rung for every metric or a
    ``{metric_name: rung}`` mapping (missing names ride ``exact``)."""
    from torcheval_tpu_torch import config

    block = config.wire_block_size()
    if isinstance(compression, str):
        rung_of = dict.fromkeys({m for m, _ in order}, compression)
    else:
        rung_of = dict(compression)
    meta: List[_StateMeta] = []
    chunks: List[np.ndarray] = []
    for metric_name, state_name in order:
        value = metric_states[metric_name][state_name]
        if isinstance(value, (torch.Tensor, np.ndarray)):
            kind, arrs, extra = "tensor", [_as_numpy(value)], None
        elif isinstance(value, list):
            kind, arrs, extra = "list", [_as_numpy(a) for a in value], None
        elif isinstance(value, dict):
            keys = sorted(value.keys())
            kind, arrs, extra = "dict", [_as_numpy(value[k]) for k in keys], keys
        else:  # int/float (and any other picklable scalar state)
            kind, arrs, extra = "obj", [], value
        entries = []
        rung = rung_of.get(metric_name, "exact")
        for a in arrs:
            entry, wire_chunks = _encode_array(a, rung, block)
            entries.append(entry)
            chunks.extend(wire_chunks)
        meta.append((kind, entries, extra))
    flat = np.concatenate(chunks) if chunks else np.zeros(0, dtype=np.uint8)
    return meta, flat


def _meta_wire_tiers(
    order: List[Tuple[str, str]], metas: List[List[_StateMeta]]
) -> Dict[str, str]:
    """Per metric, the rung its payload actually rode across the given
    ranks' metadata: the lossiest encoding any rank applied to any of its
    arrays (a metric whose payloads stayed raw or sparse reads
    ``"exact"`` whatever the policy asked)."""
    tiers: Dict[str, str] = {m: "exact" for m, _ in order}
    for meta in metas:
        for (metric_name, _), (_kind, entries, _extra) in zip(order, meta):
            for entry in entries:
                enc = entry[2]
                tier = _ENC_TIERS[enc[0] if isinstance(enc, tuple) else None]
                if wirelib.rung_index(tier) > wirelib.rung_index(tiers[metric_name]):
                    tiers[metric_name] = tier
    return tiers


def _unpack_rank_states(
    template: MetricStates,
    order: List[Tuple[str, str]],
    meta: List[_StateMeta],
    buf: np.ndarray,
) -> MetricStates:
    """Inverse of ``_pack_rank_states`` for one rank's gathered bytes."""
    out: MetricStates = {m: {} for m in template}
    offset = 0
    for (metric_name, state_name), (kind, entries, extra) in zip(order, meta):
        arrs = []
        for entry in entries:
            arr, offset = _decode_array(buf, offset, entry)
            arrs.append(arr)
        if kind == "tensor":
            value: Any = arrs[0]
        elif kind == "list":
            value = arrs
        elif kind == "dict":
            value = dict(zip(extra, arrs))
        else:
            value = extra
        out[metric_name][state_name] = value
    return out


def canonical_crc(
    order: List[Tuple[str, str]], meta: List[_StateMeta], buf: np.ndarray
) -> int:
    """crc32 over the canonical bytes of a packed payload after
    dequantization: decode the wire, re-pack at the exact rung, crc that.
    Under a lossy rung the receiver merges the reconstruction, so an
    integrity check (the federation's epoch ledger) must pin that, not the
    bytes that travelled. Sender and receiver run it on the same wire
    bytes: deterministic, and no communication."""
    template: MetricStates = {m: {} for m, _ in order}
    states = _unpack_rank_states(template, order, meta, np.asarray(buf, dtype=np.uint8))
    _, flat = _pack_rank_states(states, order, "exact")
    return zlib.crc32(flat.tobytes())


def sync_states(
    metric_states,
    process_group: ProcessGroup,
    *,
    families: Optional[Dict[str, str]] = None,
) -> SyncedStates:
    """Gather every rank's metric states to every rank, through the wire
    protocol; returns the surviving ranks' states as numpy, in rank order,
    as a :class:`SyncedStates`.

    Under a ``LocalReplicaGroup`` (also behind wrappers: the dispatch is on
    ``process_group.unwrap()``), ``metric_states`` is the per-replica list
    ``[{metric_name: state_dict}, ...]``; under a multi-process group it
    is this process's ``{metric_name: state_dict}``. Either way the states
    are packed to host numpy on the caller's thread and travel through one
    ``allgather_object`` (each rank's metadata, scalar states, payload
    size and crc32) and at most one ``allgather_array`` (the payloads,
    padded to the longest on the multi-process path).

    ``families`` maps metric names to their ladder family (metric class
    name): each metric then rides ``wire.effective_rung(family)``.
    Without it every metric rides the ladder's default rung.
    """
    from torcheval_tpu_torch import config

    if families is None:
        compression: Any = config.wire_rung_for("*")
    else:
        compression = {name: wirelib.effective_rung(f) for name, f in families.items()}
    local_mode = isinstance(process_group.unwrap(), LocalReplicaGroup)
    template = metric_states[0] if local_mode else metric_states
    order = metrics_traversal_order(template)
    world = process_group.world_size
    if local_mode:
        packed = [_pack_rank_states(ms, order, compression) for ms in metric_states]
        sent_bytes = sum(int(flat.size) for _, flat in packed)
        metas, meta_ranks = process_group.allgather_object_with_ranks(
            [(meta, int(flat.size), zlib.crc32(flat)) for meta, flat in packed]
        )
        if all(size == 0 for _, size, _ in metas):
            bufs = [np.zeros(0, dtype=np.uint8)] * len(metas)
            buf_ranks = list(meta_ranks)
        else:
            bufs, buf_ranks = process_group.allgather_array_with_ranks(
                [flat for _, flat in packed]
            )
    else:
        meta, flat = _pack_rank_states(metric_states, order, compression)
        sent_bytes = int(flat.size)
        metas, meta_ranks = process_group.allgather_object_with_ranks(
            (meta, int(flat.size), zlib.crc32(flat))
        )
        max_bytes = max(size for _, size, _ in metas)
        if max_bytes == 0:
            bufs = [np.zeros(0, dtype=np.uint8)] * len(metas)
            buf_ranks = list(meta_ranks)
        else:
            padded = np.zeros(max_bytes, dtype=np.uint8)
            padded[: flat.size] = flat
            bufs, buf_ranks = process_group.allgather_array_with_ranks(padded)
    out = _assemble(
        template, order, process_group, world,
        dict(zip(meta_ranks, metas)), dict(zip(buf_ranks, bufs)),
    )
    out.sent_bytes = sent_bytes
    return out


def _assemble(
    template: MetricStates,
    order: List[Tuple[str, str]],
    process_group: ProcessGroup,
    world: int,
    meta_by_rank: Dict[int, Tuple[List[_StateMeta], int, int]],
    buf_by_rank: Dict[int, np.ndarray],
) -> SyncedStates:
    """Intersect the two gathers' participants, verify payload integrity,
    enforce the quorum, and unpack the survivors."""
    policy = getattr(process_group, "degradation_policy", "raise")
    own = process_group.rank
    survivors: List[int] = []
    for rank in sorted(meta_by_rank):
        if rank not in buf_by_rank:
            continue  # the payload gather lost this rank after metadata
        _, size, crc = meta_by_rank[rank]
        buf = np.asarray(buf_by_rank[rank], dtype=np.uint8)
        if zlib.crc32(buf[:size].tobytes()) != crc:
            if hasattr(process_group, "note_corrupt"):
                process_group.note_corrupt(rank)
            if policy == "raise":
                raise SyncIntegrityError(
                    f"rank {rank}'s gathered metric-state payload failed "
                    f"its checksum ({size} bytes); refusing to merge "
                    "corrupt state (degradation policy 'raise')"
                )
            continue  # quorum/local: a corrupt rank is a lost rank
        survivors.append(rank)
    if policy == "local" and survivors != sorted(meta_by_rank):
        # the local policy degrades the whole sync to this rank's own
        # state the moment anything was lost, never a partial peer merge
        survivors = [own] if own in survivors else []
    quorum = getattr(process_group, "quorum_fraction", None)
    if policy == "quorum" and quorum is not None:
        needed = quorum_count(quorum, world)
        if len(survivors) < needed:
            raise SyncTimeoutError(
                f"metric sync quorum not met after integrity checks: "
                f"{len(survivors)}/{world} usable ranks, quorum requires "
                f">= {needed}"
            )
    if not survivors:
        raise SyncTimeoutError(
            "metric sync retained no usable rank (all payloads lost or corrupt)"
        )
    if hasattr(process_group, "note_sync_result"):
        process_group.note_sync_result(survivors, world)
    out = SyncedStates(
        _unpack_rank_states(
            template, order, meta_by_rank[rank][0],
            np.asarray(buf_by_rank[rank], dtype=np.uint8),
        )
        for rank in survivors
    )
    out.ranks = tuple(survivors)
    out.world_size = world
    out.recv_bytes = sum(meta_by_rank[r][1] for r in survivors)
    out.wire_tiers = _meta_wire_tiers(order, [meta_by_rank[r][0] for r in survivors])
    return out
