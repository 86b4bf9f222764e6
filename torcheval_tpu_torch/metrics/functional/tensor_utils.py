"""Shared numeric helpers for functional metrics.

Counterpart of ``torcheval_tpu/metrics/functional/tensor_utils.py``:
``nan_safe_divide``, ``argmax_last`` and ``correct_mask`` with the JAX
package's pinned semantics -- first index on ties, NaN wins, -0.0 ties
with +0.0, and a target outside ``[0, C)`` never matches.
"""

from __future__ import annotations

import torch

_INT32_MAX = 0x7FFFFFFF


def nan_safe_divide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a / b`` yielding NaN (not inf) where ``b == 0``."""
    zero = b == 0
    return torch.where(
        zero,
        torch.full_like(a, float("nan")),
        a / torch.where(zero, torch.ones_like(b), b),
    )


def _order_key(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving int32 key of a float32 tensor: negative floats
    (descending bit patterns) map below positives, -0.0 maps to +0.0's
    key, and every NaN (either sign) maps to the maximum."""
    xi = x.view(torch.int32)
    # for xi < 0, xi ^ 0x7FFFFFFF == INT32_MIN - 1 - xi (the JAX key),
    # computed without an intermediate that leaves int32
    key = torch.where(xi < 0, xi ^ _INT32_MAX, xi)
    key = torch.where(key == -1, torch.zeros_like(key), key)
    return torch.where(x != x, torch.full_like(key, _INT32_MAX), key)


def argmax_last(x: torch.Tensor) -> torch.Tensor:
    """``argmax`` over the last axis with the JAX package's semantics
    (first index on ties, NaN wins, -0.0 == +0.0): the integer max of the
    order key, then the first index that reaches it, as its
    ``_argmax_last_xla`` computes it (int64 result)."""
    c = x.shape[-1]
    if x.dtype in (torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool):
        key = x.to(torch.int32)
    elif x.dtype in (torch.float32, torch.bfloat16, torch.float16):
        key = _order_key(x.to(torch.float32))
    else:  # int64/float64: an int32 key would reorder -- use the stock op
        return torch.argmax(x, dim=-1)
    mx = key.amax(dim=-1, keepdim=True)
    idx = torch.arange(c, device=x.device)
    return torch.where(key == mx, idx, c).amin(dim=-1)


def correct_mask(x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-row ``(argmax_last(x) == target)`` as float32. A target
    outside ``[0, C)`` can never equal an argmax, so it never matches."""
    return (argmax_last(x) == target).to(torch.float32)


def segment_sum(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """``jax.ops.segment_sum`` semantics: ids outside
    ``[0, num_segments)`` are dropped (``index_add_`` would raise on the
    CPU and trip a device assert on CUDA, so they are masked first)."""
    ids = segment_ids.to(torch.int64)
    valid = (ids >= 0) & (ids < num_segments)
    out = torch.zeros(num_segments, dtype=data.dtype, device=data.device)
    return out.index_add_(
        0,
        torch.where(valid, ids, torch.zeros_like(ids)),
        torch.where(valid, data, torch.zeros_like(data)),
    )
