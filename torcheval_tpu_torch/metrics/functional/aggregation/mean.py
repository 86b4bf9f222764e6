"""Weighted mean (counterpart of
``torcheval_tpu/metrics/functional/aggregation/mean.py``)."""

from __future__ import annotations

from typing import Tuple, Union

import torch

from torcheval_tpu_torch.utils.convert import (
    DeviceLike,
    functional_device,
    narrow_64,
    resolve_weight,
    to_torch_float,
)


def _weighted_sum_pair(
    input: torch.Tensor, weight: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    return torch.sum(weight * input), torch.sum(weight)


def _scalar_weight_pair(
    input: torch.Tensor, weight: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    return weight * torch.sum(input), weight * float(input.numel())


def mean(
    input,
    weight: Union[float, int, torch.Tensor] = 1.0,
    *,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Weighted mean: ``sum(weight * input) / sum(weight)`` (class
    version: ``Mean``).

    >>> import torch
    >>> from torcheval_tpu_torch.metrics.functional import mean
    >>> mean(torch.tensor([2., 3.]))
    tensor(2.5000)
    """
    input = narrow_64(to_torch_float(input, device=functional_device(device, input)))
    is_scalar, weight_t = resolve_weight(weight, input)
    weight_t = narrow_64(weight_t)
    pair = _scalar_weight_pair if is_scalar else _weighted_sum_pair
    weighted_sum, weights = pair(input, weight_t)
    return weighted_sum / weights
