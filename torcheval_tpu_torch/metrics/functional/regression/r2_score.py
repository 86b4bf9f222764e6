"""R-squared score, plain, adjusted and variance-weighted (counterpart of
``torcheval_tpu/metrics/functional/regression/r2_score.py``).

An update returns the sufficient statistics (sum of y^2, sum of y, the
residual sum of squares and a float32 observation count); the compute
reads the count on the host for its sample-count checks, as the JAX
package does. The mask-aware twin (shape bucketing) adds zero for a padded
row to all four statistics.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from torcheval_tpu_torch.metrics.functional.tensor_utils import valid_mask, xla_mean
from torcheval_tpu_torch.utils.convert import DeviceLike, functional_device, to_torch_float


def _update(
    input: torch.Tensor, target: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    sum_squared_obs = torch.sum(torch.square(target), dim=0)
    sum_obs = torch.sum(target, dim=0)
    sum_squared_residual = torch.sum(torch.square(target - input), dim=0)
    # a fill, not a host-to-device copy: the update never synchronizes
    n = torch.full((), float(target.shape[0]), dtype=torch.float32, device=target.device)
    return sum_squared_obs, sum_obs, sum_squared_residual, n


def _update_masked(
    input: torch.Tensor, target: torch.Tensor, valid_sizes: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mask-aware twin of ``_update`` (shape bucketing)."""
    valid = valid_mask(target.shape[0], valid_sizes[0])
    w = valid[:, None] if target.ndim == 2 else valid
    sum_squared_obs = torch.sum(torch.square(target) * w, dim=0)
    sum_obs = torch.sum(target * w, dim=0)
    sum_squared_residual = torch.sum(torch.square(target - input) * w, dim=0)
    return sum_squared_obs, sum_obs, sum_squared_residual, torch.sum(valid)


def _compute(
    sum_squared_obs: torch.Tensor,
    sum_obs: torch.Tensor,
    rss: torch.Tensor,
    num_obs: torch.Tensor,
    multioutput: str,
    num_regressors: int,
) -> torch.Tensor:
    tss = sum_squared_obs - torch.square(sum_obs) / num_obs
    r_squared = 1 - (rss / tss)
    if multioutput == "uniform_average":
        r_squared = xla_mean(r_squared)
    elif multioutput == "variance_weighted":
        r_squared = torch.sum(r_squared * tss / torch.sum(tss))
    if num_regressors != 0:
        r_squared = 1 - (1 - r_squared) * (num_obs - 1) / (num_obs - num_regressors - 1)
    return r_squared


def _r2_score_compute(
    sum_squared_obs: torch.Tensor,
    sum_obs: torch.Tensor,
    rss: torch.Tensor,
    num_obs: torch.Tensor,
    multioutput: str,
    num_regressors: int,
    n_host: Optional[float] = None,
) -> torch.Tensor:
    # the functional form knows the count from the input's shape; the class
    # reads its accumulated counter back once
    n = float(num_obs) if n_host is None else float(n_host)
    if n < 2:
        raise ValueError(
            "There is no enough data for computing. Needs at least two "
            "samples to calculate r2 score."
        )
    if num_regressors >= n - 1:
        raise ValueError(
            "The `num_regressors` must be smaller than n_samples - 1, "
            f"got num_regressors={num_regressors}, n_samples={n}."
        )
    return _compute(sum_squared_obs, sum_obs, rss, num_obs, multioutput, num_regressors)


def _r2_score_param_check(multioutput: str, num_regressors: int) -> None:
    if multioutput not in ("raw_values", "uniform_average", "variance_weighted"):
        raise ValueError(
            "The `multioutput` must be either `raw_values` or "
            "`uniform_average` or `variance_weighted`, "
            f"got multioutput={multioutput}."
        )
    if not isinstance(num_regressors, int) or num_regressors < 0:
        raise ValueError(
            "The `num_regressors` must an integer larger or equal to zero, "
            f"got num_regressors={num_regressors}."
        )


def _r2_score_update_input_check(input: torch.Tensor, target: torch.Tensor) -> None:
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


def r2_score(
    input,
    target,
    *,
    multioutput: str = "uniform_average",
    num_regressors: int = 0,
    device: DeviceLike = None,
) -> torch.Tensor:
    """R-squared score of ``input`` against ``target``, each (n_sample,) or
    (n_sample, n_output). ``multioutput`` is ``uniform_average``,
    ``raw_values`` or ``variance_weighted``; a nonzero ``num_regressors``
    gives the adjusted score (class version: ``R2Score``).

    >>> import torch
    >>> from torcheval_tpu_torch.metrics.functional import r2_score
    >>> r2_score(torch.tensor([0., 2., 1., 3.]), torch.tensor([0., 1., 2., 3.]))
    tensor(0.6000)
    """
    _r2_score_param_check(multioutput, num_regressors)
    dev = functional_device(device, input, target)
    input, target = to_torch_float(input, device=dev), to_torch_float(target, device=dev)
    _r2_score_update_input_check(input, target)
    sum_squared_obs, sum_obs, rss, num_obs = _update(input, target)
    return _r2_score_compute(
        sum_squared_obs, sum_obs, rss, num_obs, multioutput, num_regressors,
        n_host=target.shape[0],
    )
