"""MeanSquaredError class metric (counterpart of
``torcheval_tpu/metrics/regression/mean_squared_error.py``). The states
start as scalars and broadcast to per-output sums under addition, so the
SUM merge covers a replica that saw 2-D input. Both plans declare their
mask-aware twins for shape bucketing."""

from __future__ import annotations

from typing import TypeVar

import torch

from torcheval_tpu_torch.metrics.functional.regression.mean_squared_error import (
    _mean_squared_error_compute,
    _mean_squared_error_param_check,
    _mean_squared_error_update_input_check,
    _update_unweighted,
    _update_unweighted_masked,
    _update_weighted,
    _update_weighted_masked,
)
from torcheval_tpu_torch.metrics.metric import MergeKind, Metric, UpdatePlan
from torcheval_tpu_torch.utils.convert import DeviceLike, narrow_64

TMeanSquaredError = TypeVar("TMeanSquaredError", bound="MeanSquaredError")


class MeanSquaredError(Metric[torch.Tensor]):
    """Mean squared error over all updates (functional version:
    ``mean_squared_error``); ``multioutput`` is ``uniform_average`` or
    ``raw_values``.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import MeanSquaredError
    >>> metric = MeanSquaredError(device="cpu")
    >>> metric.update(torch.tensor([0.9, 0.5, 0.3, 0.5]),
    ...               torch.tensor([0.5, 0.8, 0.2, 0.8])).compute()
    tensor(0.0875)
    """

    def __init__(
        self, *, multioutput: str = "uniform_average", device: DeviceLike = None
    ) -> None:
        super().__init__(device=device)
        _mean_squared_error_param_check(multioutput)
        self.multioutput = multioutput
        self._add_state("sum_squared_error", torch.zeros(()), merge=MergeKind.SUM)
        self._add_state("sum_weight", torch.zeros(()), merge=MergeKind.SUM)

    def update(
        self: TMeanSquaredError, input, target, *, sample_weight=None
    ) -> TMeanSquaredError:
        """Accumulate one batch: ``input`` and ``target`` (n_sample,) or
        (n_sample, n_output), optional (n_sample,) ``sample_weight``."""
        return self._apply_update_plan(
            self._update_plan(input, target, sample_weight=sample_weight)
        )

    def _update_plan(self, input, target, *, sample_weight=None):
        input = narrow_64(self._input_float(input))
        target = narrow_64(self._input_float(target))
        if sample_weight is not None:
            sample_weight = narrow_64(self._input_float(sample_weight))
        _mean_squared_error_update_input_check(input, target, sample_weight)
        names = ("sum_squared_error", "sum_weight")
        if sample_weight is None:
            return UpdatePlan(
                _update_unweighted, names, (input, target),
                masked_kernel=_update_unweighted_masked,
                batch_axes=(("batch",), ("batch",)),
            )
        return UpdatePlan(
            _update_weighted, names, (input, target, sample_weight),
            masked_kernel=_update_weighted_masked,
            batch_axes=(("batch",), ("batch",), ("batch",)),
        )

    def compute(self) -> torch.Tensor:
        """The MSE; NaN before any update."""
        return _mean_squared_error_compute(
            self.sum_squared_error, self.multioutput, self.sum_weight
        )
