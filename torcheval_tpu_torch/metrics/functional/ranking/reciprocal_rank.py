"""Reciprocal rank.

Counterpart of ``torcheval_tpu/metrics/functional/ranking/
reciprocal_rank.py``: ``1 / (rank + 1)`` with the rank counted as in
``hit_rate`` (the same target index rules), 0 for a rank at or past
``k``.
"""

from __future__ import annotations

from typing import Optional

import torch

from torcheval_tpu_torch.metrics.functional.ranking.hit_rate import (
    _debug_check_target_range,
    _target_rank,
)
from torcheval_tpu_torch.utils.convert import (
    DeviceLike,
    functional_device,
    narrow_64,
    to_torch,
)


def _reciprocal_rank_input_check(input: torch.Tensor, target: torch.Tensor) -> None:
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


def _reciprocal_rank_compute(
    input: torch.Tensor, target: torch.Tensor, k: Optional[int]
) -> torch.Tensor:
    rank = _target_rank(input, target)
    score = torch.reciprocal((rank + 1).to(torch.float32))
    if k is not None:
        score = torch.where(rank >= k, torch.zeros_like(score), score)
    return score


def reciprocal_rank(
    input, target, *, k: Optional[int] = None, device: DeviceLike = None
) -> torch.Tensor:
    """Per-example reciprocal rank of the target class in
    ``(num_samples, num_classes)`` ``input``; with ``k``, an example whose
    target is not in its top ``k`` scores 0 (class version:
    ``ReciprocalRank``).

    >>> import torch
    >>> from torcheval_tpu_torch.metrics.functional import reciprocal_rank
    >>> reciprocal_rank(torch.tensor([[0.3, 0.1, 0.6], [0.5, 0.2, 0.3]]),
    ...                 torch.tensor([2, 1]))
    tensor([1.0000, 0.3333])
    """
    dev = functional_device(device, input, target)
    input = narrow_64(to_torch(input, device=dev))
    target = to_torch(target, device=dev)
    _reciprocal_rank_input_check(input, target)
    _debug_check_target_range(input, target)
    return _reciprocal_rank_compute(input, target, k)
