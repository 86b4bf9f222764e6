"""R2Score class metric (counterpart of
``torcheval_tpu/metrics/regression/r2_score.py``). The sufficient
statistics start as scalars and broadcast to per-output sums under
addition; ``num_obs`` is a float32 counter, as in the JAX package. The
plan declares its mask-aware twin for shape bucketing."""

from __future__ import annotations

from typing import TypeVar

import torch

from torcheval_tpu_torch.metrics.functional.regression.r2_score import (
    _r2_score_compute,
    _r2_score_param_check,
    _r2_score_update_input_check,
    _update as _r2_update_kernel,
    _update_masked as _r2_update_kernel_masked,
)
from torcheval_tpu_torch.metrics.metric import MergeKind, Metric, UpdatePlan
from torcheval_tpu_torch.utils.convert import DeviceLike, narrow_64

TR2Score = TypeVar("TR2Score", bound="R2Score")


class R2Score(Metric[torch.Tensor]):
    """R-squared score over all updates (functional version: ``r2_score``).

    Args:
        multioutput: ``uniform_average`` [default], ``raw_values`` or
            ``variance_weighted``.
        num_regressors: number of independent variables; nonzero gives the
            adjusted score.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import R2Score
    >>> metric = R2Score(device="cpu")
    >>> metric.update(torch.tensor([0., 2., 1., 3.]), torch.tensor([0., 1., 2., 3.])).compute()
    tensor(0.6000)
    """

    def __init__(
        self,
        *,
        multioutput: str = "uniform_average",
        num_regressors: int = 0,
        device: DeviceLike = None,
    ) -> None:
        super().__init__(device=device)
        _r2_score_param_check(multioutput, num_regressors)
        self.multioutput = multioutput
        self.num_regressors = num_regressors
        self._add_state("sum_squared_obs", torch.zeros(()), merge=MergeKind.SUM)
        self._add_state("sum_obs", torch.zeros(()), merge=MergeKind.SUM)
        self._add_state("sum_squared_residual", torch.zeros(()), merge=MergeKind.SUM)
        self._add_state("num_obs", torch.zeros(()), merge=MergeKind.SUM)

    def _update_plan(self, input, target):
        input = narrow_64(self._input_float(input))
        target = narrow_64(self._input_float(target))
        _r2_score_update_input_check(input, target)
        return UpdatePlan(
            _r2_update_kernel,
            ("sum_squared_obs", "sum_obs", "sum_squared_residual", "num_obs"),
            (input, target),
            masked_kernel=_r2_update_kernel_masked,
            batch_axes=(("batch",), ("batch",)),
        )

    def update(self: TR2Score, input, target) -> TR2Score:
        """Accumulate one batch of predictions and ground truth."""
        return self._apply_update_plan(self._update_plan(input, target))

    def compute(self) -> torch.Tensor:
        """The R2 score; raises before two samples have been seen."""
        return _r2_score_compute(
            self.sum_squared_obs,
            self.sum_obs,
            self.sum_squared_residual,
            self.num_obs,
            self.multioutput,
            self.num_regressors,
        )
