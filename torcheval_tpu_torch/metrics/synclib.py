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
capacity) unpack. The bf16/int8 wire rungs and the resilience layer are
later slices.
"""

from __future__ import annotations

import zlib
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from torcheval_tpu_torch.distributed import LocalReplicaGroup, ProcessGroup

# {metric_name: {state_name: TState}}
MetricStates = Dict[str, Dict[str, Any]]

# (kind, [(shape, dtype, enc), ...], extra): kind "tensor" | "list" | "dict"
# | "obj"; enc None (raw bytes) or ("sparse", nnz, dtype); extra carries the
# sorted dict keys, or the value itself for "obj"
_StateMeta = Tuple[str, List[Tuple[Tuple[int, ...], str, Any]], Any]

# sparse pays for its nonzero scan only on payloads at least this large,
# and only when it at least halves the bytes
_SPARSE_MIN_BYTES = 4096

_BIT_VIEWS = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


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
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _encode_array(a: np.ndarray):
    """One array -> (meta entry, wire chunks) at the exact tier."""
    shape = tuple(a.shape)
    dtype = str(a.dtype)
    flat = np.ascontiguousarray(a).reshape(-1)
    bits = _BIT_VIEWS.get(flat.dtype.itemsize)
    if bits is not None and flat.nbytes >= _SPARSE_MIN_BYTES and flat.size < 2**32:
        idx = np.flatnonzero(flat.view(bits))
        if idx.size * (4 + flat.dtype.itemsize) * 2 <= flat.nbytes:
            return (shape, dtype, ("sparse", int(idx.size), dtype)), [
                idx.astype(np.uint32).view(np.uint8),
                np.ascontiguousarray(flat[idx]).view(np.uint8),
            ]
    return (shape, dtype, None), [flat.view(np.uint8)]


def _decode_array(buf: np.ndarray, offset: int, entry) -> Tuple[np.ndarray, int]:
    """Inverse of ``_encode_array`` for one gathered entry."""
    shape, dtype, enc = entry
    dtype = np.dtype(dtype)
    size = int(np.prod(shape, dtype=np.int64))
    if enc is None:
        nbytes = size * dtype.itemsize
        return buf[offset : offset + nbytes].view(dtype).reshape(shape), offset + nbytes
    if enc[0] == "sparse":
        nnz = enc[1]
        idx = buf[offset : offset + nnz * 4].view(np.uint32)
        offset += nnz * 4
        vals = buf[offset : offset + nnz * dtype.itemsize].view(dtype)
        offset += nnz * dtype.itemsize
        out = np.zeros(size, dtype=dtype)
        out[idx] = vals
        return out.reshape(shape), offset
    raise ValueError(f"unknown wire encoding {enc!r}")


def _pack_rank_states(
    metric_states: MetricStates, order: List[Tuple[str, str]]
) -> Tuple[List[_StateMeta], np.ndarray]:
    """Pack one rank's states, in traversal order, into (metadata, flat
    uint8 payload)."""
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
        for a in arrs:
            entry, wire_chunks = _encode_array(a)
            entries.append(entry)
            chunks.extend(wire_chunks)
        meta.append((kind, entries, extra))
    flat = np.concatenate(chunks) if chunks else np.zeros(0, dtype=np.uint8)
    return meta, flat


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


def sync_states(metric_states, process_group: ProcessGroup) -> List[MetricStates]:
    """Gather every rank's metric states to every rank, through the wire
    protocol; returns the per-rank states as numpy, in rank order.

    Under a ``LocalReplicaGroup``, ``metric_states`` is the per-replica
    list ``[{metric_name: state_dict}, ...]``; under a multi-process group
    it is this process's ``{metric_name: state_dict}``. Either way the
    states travel through one ``allgather_object`` (each rank's metadata,
    scalar states, payload size and crc32) and at most one
    ``allgather_array`` (the payloads, padded to the longest on the
    multi-process path).
    """
    if isinstance(process_group, LocalReplicaGroup):
        template = metric_states[0]
        order = metrics_traversal_order(template)
        packed = [_pack_rank_states(ms, order) for ms in metric_states]
        metas = process_group.allgather_object(
            [(meta, int(flat.size), zlib.crc32(flat)) for meta, flat in packed]
        )
        if all(size == 0 for _, size, _ in metas):
            bufs = [np.zeros(0, dtype=np.uint8)] * len(metas)
        else:
            bufs = process_group.allgather_array([flat for _, flat in packed])
    else:
        template = metric_states
        order = metrics_traversal_order(template)
        meta, flat = _pack_rank_states(metric_states, order)
        metas = process_group.allgather_object((meta, int(flat.size), zlib.crc32(flat)))
        max_bytes = max(size for _, size, _ in metas)
        if max_bytes == 0:
            bufs = [np.zeros(0, dtype=np.uint8)] * len(metas)
        else:
            padded = np.zeros(max_bytes, dtype=np.uint8)
            padded[: flat.size] = flat
            bufs = process_group.allgather_array(padded)
    out = []
    for rank, ((meta, size, crc), buf) in enumerate(zip(metas, bufs)):
        buf = np.asarray(buf, dtype=np.uint8)
        if zlib.crc32(buf[:size].tobytes()) != crc:
            raise RuntimeError(
                f"rank {rank}'s gathered metric-state payload failed its "
                f"checksum ({size} bytes); refusing to merge corrupt state"
            )
        out.append(_unpack_rank_states(template, order, meta, buf))
    return out
