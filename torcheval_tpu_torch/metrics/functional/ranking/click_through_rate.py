"""Click-through rate.

Counterpart of ``torcheval_tpu/metrics/functional/ranking/
click_through_rate.py``. A scalar weight and a tensor of weights take
different kernels: the scalar form scales the summed clicks and the event
count (integer clicks are summed as integers, then cast); the compute
divides by ``weight_total + finfo(float32).tiny``, so a task with no
weight reads 0, not NaN.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from torcheval_tpu_torch.utils.convert import (
    DeviceLike,
    functional_device,
    narrow_64,
    to_torch,
    to_torch_float,
)

_TINY32 = torch.finfo(torch.float32).tiny


def _ctr_update_weighted(
    input: torch.Tensor, weights: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    weights = weights.to(torch.float32)
    return torch.sum(input * weights, dim=-1), torch.sum(weights, dim=-1)


def _ctr_update_scalar(
    input: torch.Tensor, weight: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    click_total = weight * torch.sum(input, dim=-1).to(torch.float32)
    weight_total = weight * input.shape[-1] * torch.ones_like(click_total)
    return click_total, weight_total


def resolve_ctr_weights(
    input: torch.Tensor,
    weights: Union[torch.Tensor, float, int],
    *,
    num_tasks: int,
    convert=None,
) -> Tuple:
    """Split CTR ``weights`` into the scalar or tensor kernel and its
    arguments, after the input check; ``(kernel, kernel_args)``. A Python
    number is a scalar weight (a float32 0-d tensor on ``input``'s
    device); anything else goes through ``convert`` (default: a float
    tensor on ``input``'s device)."""
    is_scalar = isinstance(weights, (float, int))
    if is_scalar:
        weights_t = None
    elif convert is None:
        weights_t = narrow_64(to_torch_float(weights, device=input.device))
    else:
        weights_t = narrow_64(convert(weights))
    _click_through_rate_input_check(input, weights_t, is_scalar, num_tasks=num_tasks)
    if is_scalar:
        w = torch.full((), float(weights), dtype=torch.float32, device=input.device)
        return _ctr_update_scalar, (input, w)
    return _ctr_update_weighted, (input, weights_t)


def _click_through_rate_compute(
    click_total: torch.Tensor, weight_total: torch.Tensor
) -> torch.Tensor:
    return click_total / (weight_total + _TINY32)


def _click_through_rate_input_check(
    input: torch.Tensor,
    weights: Optional[torch.Tensor],
    is_scalar_weight: bool,
    *,
    num_tasks: int,
) -> None:
    if input.ndim != 1 and input.ndim != 2:
        raise ValueError(
            "`input` should be a one or two dimensional tensor, got shape "
            f"{input.shape}."
        )
    if not is_scalar_weight and weights.shape != input.shape:
        raise ValueError(
            "tensor `weights` should have the same shape as tensor `input`, "
            f"got shapes {weights.shape} and {input.shape}, respectively."
        )
    if num_tasks == 1:
        if input.ndim > 1:
            raise ValueError(
                "`num_tasks = 1`, `input` is expected to be one-dimensional "
                f"tensor, but got shape ({input.shape})."
            )
    elif input.ndim == 1 or input.shape[0] != num_tasks:
        raise ValueError(
            f"`num_tasks = {num_tasks}`, `input`'s shape is expected to be "
            f"({num_tasks}, num_samples), but got shape ({input.shape})."
        )


def click_through_rate(
    input,
    weights: Optional[Union[torch.Tensor, float, int]] = None,
    *,
    num_tasks: int = 1,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Click-through rate from click (1) / skip (0) events of shape
    ``(num_events,)`` or ``(num_tasks, num_events)``, optionally weighted
    per event (class version: ``ClickThroughRate``).

    >>> import torch
    >>> from torcheval_tpu_torch.metrics.functional import click_through_rate
    >>> click_through_rate(torch.tensor([0, 1, 0, 1, 1, 0, 0, 1]))
    tensor(0.5000)
    """
    if weights is None:
        weights = 1.0
    input = narrow_64(to_torch(input, device=functional_device(device, input, weights)))
    kernel, args = resolve_ctr_weights(input, weights, num_tasks=num_tasks)
    return _click_through_rate_compute(*kernel(*args))
