"""Fixed-width histogram and bincount.

Counterpart of ``torcheval_tpu/ops/histogram.py`` (``histogram`` :119,
``bincount`` :170), in plain torch ops on the segment reductions of
``ops/segment.py``.

``histogram`` bins as the JAX package's ``_histogram_xla`` (:36) does
under ``jax.jit``, the form it runs on the TPU, bit for bit:

- the edge constants are float32: ``lo32 = f32(lo)``, ``hi32 = f32(hi)``
  and ``span32 = f32(hi - lo)`` from the double difference;
- ``valid = (v >= lo32) & (v <= hi32)``, so NaN and out-of-range samples
  drop and the last bin is closed at ``hi``;
- XLA rewrites ``(v - lo32) / span32 * f32(num_bins)`` into one multiply
  by the folded constant ``f32(f32(1 / span32) * f32(num_bins))``, so the
  bin is ``clip(int((v - lo32) * scale32), 0, num_bins - 1)``. The
  subtraction and the multiply are separate torch ops, so nothing
  contracts them into a fused multiply-add.

The JAX package's CPU ``native`` kernel divides instead, so on bounds
whose span is not a power of two an edge sample can land one bin apart
from it. Not ``torch.histc``, whose edge arithmetic is another.
Denormal samples compare as they are here; XLA on the CPU and the TPU
flushes them to zero first.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from torcheval_tpu_torch.ops.segment import safe_ids, segment_count, segment_sum


def _bin_scale(lo: float, hi: float, num_bins: int) -> Tuple[np.float32, np.float32, np.float32]:
    """``(lo32, hi32, scale32)``: the float32 constants ``_histogram_xla``
    compiles to (see the module docstring)."""
    span32 = np.float32(hi - lo)
    scale32 = np.float32(np.float32(1.0) / span32) * np.float32(num_bins)
    return np.float32(lo), np.float32(hi), scale32


def histogram(
    values: torch.Tensor,
    num_bins: int,
    *,
    bounds: Tuple[float, float],
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(num_bins,) float32 weighted histogram of ``values`` over fixed
    ``bounds = (lo, hi)``; out-of-range and NaN samples are dropped.
    Differentiable in ``weights`` (the bins are piecewise constant in
    ``values``).

    >>> import torch
    >>> from torcheval_tpu_torch.ops import histogram
    >>> histogram(torch.tensor([0.1, 0.6, 0.9, 2.0]), 2, bounds=(0.0, 1.0))
    tensor([1., 2.])
    """
    values = values.reshape(-1)
    if weights is not None:
        weights = weights.reshape(-1)
        if weights.shape != values.shape:
            raise ValueError(
                f"weights shape {tuple(weights.shape)} != values {tuple(values.shape)}"
            )
    if num_bins < 1:
        raise ValueError(f"num_bins must be >= 1, got {num_bins}.")
    lo, hi = float(bounds[0]), float(bounds[1])
    if not hi > lo:
        raise ValueError(f"bounds must satisfy hi > lo, got ({lo}, {hi}).")
    v = values.to(torch.float32)
    lo32, hi32, scale32 = _bin_scale(lo, hi, num_bins)
    valid = (v >= float(lo32)) & (v <= float(hi32))
    shifted = v - float(lo32)
    # an invalid lane may hold any bin (NaN to int is unspecified); it
    # carries weight 0 and the clamp keeps it in range
    idx = (shifted * float(scale32)).to(torch.int32).clamp_(0, num_bins - 1)
    w = torch.ones_like(v) if weights is None else weights.to(torch.float32)
    return segment_sum(torch.where(valid, w, torch.zeros_like(w)), idx, num_bins)


def bincount(
    x: torch.Tensor,
    num_bins: int,
    *,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``torch.bincount``-shaped reduction of integer bin ids: int32
    counts without ``weights``, float32 weight sums with them. Ids outside
    ``[0, num_bins)`` are dropped.

    >>> import torch
    >>> from torcheval_tpu_torch.ops import bincount
    >>> bincount(torch.tensor([0, 1, 1, 3]), 3)
    tensor([1, 2, 0], dtype=torch.int32)
    """
    x = x.reshape(-1)
    if x.is_floating_point() or x.is_complex() or x.dtype == torch.bool:
        raise ValueError(f"bincount ids must be integers, got {x.dtype}.")
    if x.dtype != torch.int32:
        x = safe_ids(x, num_bins)
    if weights is None:
        return segment_count(x, num_bins)
    weights = weights.reshape(-1)
    if weights.shape != x.shape:
        raise ValueError(
            f"weights shape {tuple(weights.shape)} != ids shape {tuple(x.shape)}"
        )
    return segment_sum(weights.to(torch.float32), x, num_bins)
