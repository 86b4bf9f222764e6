"""Weighted sum (counterpart of
``torcheval_tpu/metrics/functional/aggregation/sum.py``)."""

from __future__ import annotations

from typing import Union

import torch

from torcheval_tpu_torch.utils.convert import (
    DeviceLike,
    functional_device,
    narrow_64,
    resolve_weight,
    to_torch_float,
)


def _weighted_total(input: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    # JAX promotes a float16/bfloat16 input against the float32 weight even
    # when the weight is 0-d; torch's promotion would ignore a 0-d operand
    dtype = torch.promote_types(input.dtype, weight.dtype)
    return torch.sum(input.to(dtype) * weight)


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
    input = narrow_64(to_torch_float(input, device=functional_device(device, input)))
    _, weight_t = resolve_weight(weight, input, int_clause=True)
    weight_t = narrow_64(weight_t)
    return _weighted_total(input, weight_t)
