"""Mean squared error (counterpart of
``torcheval_tpu/metrics/functional/regression/mean_squared_error.py``).

An update returns the (per-output) sum of squared errors and the weight
sum; the compute divides with the signed clamp of the weight sum. The
mask-aware twins (shape bucketing) treat a padded row as a weight-0 row.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from torcheval_tpu_torch.metrics.functional.tensor_utils import valid_mask, xla_mean
from torcheval_tpu_torch.utils.convert import (
    DeviceLike,
    functional_device,
    narrow_64,
    to_torch_float,
)

# the JAX package clamps with float64's eps, rounded to float32 in its
# float32 arithmetic
_EPS = float(torch.finfo(torch.float64).eps)


def _update_unweighted(
    input: torch.Tensor, target: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    squared_error = torch.square(target - input)
    # a fill, not a host-to-device copy: the update never synchronizes
    n = torch.full((), float(target.shape[0]), dtype=torch.float32, device=target.device)
    return torch.sum(squared_error, dim=0), n


def _update_weighted(
    input: torch.Tensor, target: torch.Tensor, sample_weight: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    squared_error = torch.square(target - input)
    if squared_error.ndim == 2:
        sample_weight = sample_weight[:, None]
    sum_squared_error = torch.sum(squared_error * sample_weight, dim=0)
    return sum_squared_error, torch.sum(sample_weight, dim=0).squeeze()


def _update_unweighted_masked(
    input: torch.Tensor, target: torch.Tensor, valid_sizes: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask-aware twin of ``_update_unweighted``: a padded row's squared
    error is zeroed and it adds nothing to the weight sum."""
    valid = valid_mask(target.shape[0], valid_sizes[0])
    squared_error = torch.square(target - input)
    w = valid[:, None] if squared_error.ndim == 2 else valid
    return torch.sum(squared_error * w, dim=0), torch.sum(valid)


def _update_weighted_masked(
    input: torch.Tensor,
    target: torch.Tensor,
    sample_weight: torch.Tensor,
    valid_sizes: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    valid = valid_mask(target.shape[0], valid_sizes[0])
    return _update_weighted(input, target, sample_weight * valid)


def _mean_squared_error_update(
    input: torch.Tensor, target: torch.Tensor, sample_weight: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    _mean_squared_error_update_input_check(input, target, sample_weight)
    if sample_weight is None:
        return _update_unweighted(input, target)
    return _update_weighted(input, target, sample_weight)


def _mean_squared_error_compute(
    sum_squared_error: torch.Tensor, multioutput: str, sum_weight: torch.Tensor
) -> torch.Tensor:
    sign = torch.sign(sum_weight)
    # promoted by dtype alone, as JAX does: a (n_output,) float16 sum over
    # a 0-d float32 weight sum divides in float32
    dtype = torch.promote_types(sum_squared_error.dtype, sum_weight.dtype)
    raw_values = sum_squared_error.to(dtype) / (
        torch.clamp(torch.abs(sum_weight), min=_EPS) * sign
    ).to(dtype)
    if multioutput == "raw_values":
        return raw_values
    return xla_mean(raw_values)


def _mean_squared_error_update_input_check(
    input: torch.Tensor, target: torch.Tensor, sample_weight
) -> None:
    if input.ndim == 0 or target.ndim == 0:
        raise ValueError(
            "The dimension `input` and `target` should be 1D or 2D, "
            f"got 0-d shapes {tuple(input.shape)} and {tuple(target.shape)}."
        )
    if input.ndim >= 3 or target.ndim >= 3:
        raise ValueError(
            "The dimension `input` and `target` should be 1D or 2D, "
            f"got shapes {tuple(input.shape)} and {tuple(target.shape)}."
        )
    if input.shape != target.shape:
        raise ValueError(
            "The `input` and `target` should have the same size, "
            f"got shapes {tuple(input.shape)} and {tuple(target.shape)}."
        )
    if sample_weight is not None:
        weight_shape = tuple(sample_weight.shape)
        if not weight_shape or target.shape[0] != weight_shape[0]:
            raise ValueError(
                "The first dimension of `input`, `target` and `sample_weight` "
                f"should be the same size, got shapes {tuple(input.shape)}, "
                f"{tuple(target.shape)} and {weight_shape}."
            )


def _mean_squared_error_param_check(multioutput: str) -> None:
    if multioutput not in ("raw_values", "uniform_average"):
        raise ValueError(
            "The `multioutput` must be either `raw_values` or "
            f"`uniform_average`, got multioutput={multioutput}."
        )


def mean_squared_error(
    input,
    target,
    *,
    sample_weight=None,
    multioutput: str = "uniform_average",
    device: DeviceLike = None,
) -> torch.Tensor:
    """Mean squared error of ``input`` against ``target``, each (n_sample,)
    or (n_sample, n_output), with optional (n_sample,) ``sample_weight``;
    ``multioutput`` is ``uniform_average`` (mean over outputs) or
    ``raw_values`` (class version: ``MeanSquaredError``).

    >>> import torch
    >>> from torcheval_tpu_torch.metrics.functional import mean_squared_error
    >>> mean_squared_error(torch.tensor([0.9, 0.5, 0.3, 0.5]),
    ...                    torch.tensor([0.5, 0.8, 0.2, 0.8]))
    tensor(0.0875)
    """
    _mean_squared_error_param_check(multioutput)
    dev = functional_device(device, input, target)
    input = narrow_64(to_torch_float(input, device=dev))
    target = narrow_64(to_torch_float(target, device=dev))
    if sample_weight is not None:
        sample_weight = narrow_64(to_torch_float(sample_weight, device=dev))
    sum_squared_error, sum_weight = _mean_squared_error_update(input, target, sample_weight)
    return _mean_squared_error_compute(sum_squared_error, multioutput, sum_weight)
