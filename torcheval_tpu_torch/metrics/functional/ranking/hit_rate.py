"""Hit rate @ k.

Counterpart of ``torcheval_tpu/metrics/functional/ranking/hit_rate.py``:
the target's rank is the count of strictly greater scores in its row.

The JAX package reads the target's score with ``jnp.take_along_axis``,
which wraps a negative target in ``[-C, 0)`` and fills a target outside
``[-C, C)`` with NaN (float scores; the dtype's minimum for signed
integers, its maximum for unsigned ones, ``True`` for bools). No score is
greater than NaN, so such a row ranks 0. ``_target_scores`` gives the same
values without handing ``torch.gather`` an out-of-range index, which
raises on the CPU and trips a device assert on CUDA. Under
``config.debug_validation`` a target outside ``[0, C)`` raises instead
(the check reads the targets back to the host).
"""

from __future__ import annotations

from typing import Optional

import torch

from torcheval_tpu_torch.config import debug_validation_enabled
from torcheval_tpu_torch.utils.convert import (
    DeviceLike,
    functional_device,
    narrow_64,
    to_torch,
)


def _fill_value(dtype: torch.dtype):
    """What ``take_along_axis`` reads for an out-of-range index."""
    if dtype.is_floating_point:
        return float("nan")
    if dtype == torch.bool:
        return True
    info = torch.iinfo(dtype)
    return info.max if info.min == 0 else info.min


def _debug_check_target_range(input: torch.Tensor, target: torch.Tensor) -> None:
    """Value-level label check (a host readback, so debug-tier only)."""
    if not debug_validation_enabled():
        return
    lo, hi = int(torch.min(target)), int(torch.max(target))
    if lo < 0 or hi >= input.shape[-1]:
        raise ValueError(
            f"target values must be in [0, {input.shape[-1]}), got range "
            f"[{lo}, {hi}]."
        )


def _target_scores(input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(input, target[:, None], -1)[:, 0]`` with the JAX
    package's index rules (see the module docstring)."""
    num_classes = input.shape[-1]
    t = target.to(torch.int64)
    t = torch.where(t < 0, t + num_classes, t)
    ok = (t >= 0) & (t < num_classes)
    fill = torch.full((), _fill_value(input.dtype), dtype=input.dtype, device=input.device)
    if num_classes == 0:
        return fill.expand(target.shape)
    picked = torch.gather(input, -1, torch.where(ok, t, torch.zeros_like(t))[:, None])[:, 0]
    return torch.where(ok, picked, fill)


def _target_rank(input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Count of scores strictly greater than the target's, a row."""
    return torch.sum(input > _target_scores(input, target)[:, None], dim=-1)


def _hit_rate_input_check(
    input: torch.Tensor, target: torch.Tensor, k: Optional[int] = None
) -> None:
    if target.ndim != 1:
        raise ValueError(
            f"target should be a one-dimensional tensor, got shape {target.shape}."
        )
    if input.ndim != 2:
        raise ValueError(
            f"input should be a two-dimensional tensor, got shape {input.shape}."
        )
    if input.shape[0] != target.shape[0]:
        raise ValueError(
            "`input` and `target` should have the same minibatch dimension, "
            f"got shapes {input.shape} and {target.shape}, respectively."
        )
    if k is not None and k <= 0:
        raise ValueError(f"k should be None or positive, got {k}.")


def hit_rate(
    input, target, *, k: Optional[int] = None, device: DeviceLike = None
) -> torch.Tensor:
    """Per-example hit rate of the target class among the top-k scores of
    ``(num_samples, num_classes)`` ``input``; ``k=None`` (or
    ``k >= num_classes``) counts every example a hit (class version:
    ``HitRate``).

    >>> import torch
    >>> from torcheval_tpu_torch.metrics.functional import hit_rate
    >>> hit_rate(torch.tensor([[0.3, 0.1, 0.6], [0.5, 0.2, 0.3]]),
    ...          torch.tensor([2, 1]), k=2)
    tensor([1., 0.])
    """
    dev = functional_device(device, input, target)
    input = narrow_64(to_torch(input, device=dev))
    target = to_torch(target, device=dev)
    _hit_rate_input_check(input, target, k)
    _debug_check_target_range(input, target)
    if k is None or k >= input.shape[-1]:
        return torch.ones(target.shape, dtype=torch.float32, device=dev)
    return (_target_rank(input, target) < k).to(torch.float32)
