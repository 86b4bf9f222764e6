"""Weighted calibration: ``sum(w * pred) / sum(w * label)``.

Counterpart of ``torcheval_tpu/metrics/functional/ranking/
weighted_calibration.py``.
"""

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


def _wc_update_scalar(
    input: torch.Tensor, target: torch.Tensor, weight: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    return weight * torch.sum(input, dim=-1), weight * torch.sum(target, dim=-1)


def _wc_update_tensor(
    input: torch.Tensor, target: torch.Tensor, weight: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    return torch.sum(weight * input, dim=-1), torch.sum(weight * target, dim=-1)


def _weighted_calibration_input_check(
    input: torch.Tensor,
    target: torch.Tensor,
    weight,
    num_tasks: int,
) -> None:
    if input.shape != target.shape:
        raise ValueError(
            f"`input` shape ({input.shape}) is different from `target` shape "
            f"({target.shape})"
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


def _weighted_calibration_update(
    input: torch.Tensor,
    target: torch.Tensor,
    weight: Union[float, int, torch.Tensor],
    *,
    num_tasks: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-task ``(sum(w * input), sum(w * target))`` of float inputs on
    one device, after the input check."""
    _weighted_calibration_input_check(input, target, weight, num_tasks)
    is_scalar, weight_t = resolve_weight(weight, input)
    kernel = _wc_update_scalar if is_scalar else _wc_update_tensor
    return kernel(input, target, narrow_64(weight_t))


def weighted_calibration(
    input,
    target,
    weight: Union[float, int, torch.Tensor] = 1.0,
    *,
    num_tasks: int = 1,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Weighted calibration, ``sum(input * weight) / sum(target * weight)``
    (class version: ``WeightedCalibration``).

    >>> import torch
    >>> from torcheval_tpu_torch.metrics.functional import weighted_calibration
    >>> weighted_calibration(torch.tensor([0.8, 0.4, 0.3, 0.8, 0.7, 0.6]),
    ...                      torch.tensor([1, 1, 0, 0, 1, 0]))
    tensor(1.2000)
    """
    dev = functional_device(device, input, target, weight)
    input = narrow_64(to_torch_float(input, device=dev))
    target = narrow_64(to_torch_float(target, device=dev))
    weighted_input_sum, weighted_target_sum = _weighted_calibration_update(
        input, target, weight, num_tasks=num_tasks
    )
    return weighted_input_sum / weighted_target_sum
