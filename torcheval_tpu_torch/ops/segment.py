"""Segment reductions: sum, count and max over integer segment ids.

Counterpart of ``torcheval_tpu/ops/segment.py`` (``safe_ids`` :37,
``segment_sum`` :62, ``segment_max`` :137, ``segment_count`` :189). The JAX
package runs these as XLA scatters on the TPU and as one-pass C++ kernels
on the CPU (``ops/native/segment.cc``); neither is a TPU kernel, so here
they are plain torch ops (``index_add_``, ``scatter_reduce_``) on any
device.

Drop semantics, as in the JAX package: ids outside ``[0, num_segments)``,
negative ones included, contribute to no segment. ``index_add_`` would
raise on the CPU and trip a device assert on CUDA for such ids, so their
data is replaced by the reduction's identity and their id by 0 before the
scatter. A NaN datum at an in-range id poisons only its own segment.
"""

from __future__ import annotations

from typing import Optional

import torch


def safe_ids(ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``ids`` as int32 with out-of-range values funneled to ``-1``.

    Apply before narrowing 64-bit ids: an int64 id past 2^31 would wrap
    into ``[0, num_segments)`` under a bare int32 cast; funneled to ``-1``
    first, it stays an id every op drops."""
    keep = (ids >= 0) & (ids < num_segments)
    return torch.where(keep, ids, torch.full_like(ids, -1)).to(torch.int32)


def _scatter_operands(segment_ids: torch.Tensor, num_segments: int):
    """``(valid, ids)``: which positions hold an in-range id, and the ids
    as int64 with the dropped ones set to 0 (a safe scatter target)."""
    ids = segment_ids.to(torch.int64)
    valid = (ids >= 0) & (ids < num_segments)
    return valid, torch.where(valid, ids, torch.zeros_like(ids))


def segment_sum(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """``jax.ops.segment_sum(data, segment_ids, num_segments)``: the sum of
    ``data`` rows (leading axis) per id, in ``data``'s dtype; ids outside
    ``[0, num_segments)`` are dropped. Differentiable in ``data`` (the
    gradient of a segment is a gather of it, as ``jax.grad`` gives)."""
    valid, ids = _scatter_operands(segment_ids, num_segments)
    keep = valid.reshape(valid.shape + (1,) * (data.ndim - 1))
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]), dtype=data.dtype, device=data.device)
    return out.index_add_(0, ids, torch.where(keep, data, torch.zeros_like(data)))


def segment_count(
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """int32 count of each id in ``[0, num_segments)``; ``mask`` (same
    length, any dtype) drops the positions where it is zero."""
    valid, ids = _scatter_operands(segment_ids, num_segments)
    if mask is not None:
        valid = valid & (mask != 0)
    out = torch.zeros(num_segments, dtype=torch.int32, device=segment_ids.device)
    return out.index_add_(0, ids, valid.to(torch.int32))


def segment_max(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    *,
    identity: int = 0,
) -> torch.Tensor:
    """Per-segment maximum of integer ``data`` as int32, taken with
    ``identity`` (``max(identity, data in the segment)``, as the JAX
    package's dense compare-and-reduce computes it); a segment with no
    in-range id holds ``identity``."""
    valid, ids = _scatter_operands(segment_ids, num_segments)
    fill = torch.full_like(data, identity, dtype=torch.int32)
    src = torch.where(valid, data.to(torch.int32), fill)
    out = torch.full((num_segments,), identity, dtype=torch.int32, device=data.device)
    return out.scatter_reduce_(0, ids, src, reduce="amax", include_self=True)
