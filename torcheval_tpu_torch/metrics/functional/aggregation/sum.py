"""Weighted sum (counterpart of
``torcheval_tpu/metrics/functional/aggregation/sum.py``)."""

from __future__ import annotations

from typing import Union

import torch

from torcheval_tpu_torch.utils.convert import (
    DeviceLike,
    functional_device,
    resolve_weight,
    to_torch_float,
)


def _weighted_total(input: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    return torch.sum(input * weight)


def sum(
    input,
    weight: Union[float, int, torch.Tensor] = 1.0,
    *,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Weighted sum: ``sum(weight * input)`` (class version: ``Sum``).

    >>> import torch
    >>> from torcheval_tpu_torch.metrics.functional import sum
    >>> sum(torch.tensor([2., 3.]))
    tensor(5.)
    """
    input = to_torch_float(input, device=functional_device(device, input))
    _, weight_t = resolve_weight(weight, input, int_clause=True)
    return _weighted_total(input, weight_t)
