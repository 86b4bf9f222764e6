"""WindowedMeanSquaredError (counterpart of
``torcheval_tpu/metrics/window/mean_squared_error.py``). Inputs are
``(num_samples,)`` for one task or ``(num_samples, num_tasks)``, the
reference's column layout, unlike CTR and NE's ``(num_tasks,
num_samples)`` rows. The lifetime states start as scalars and become
per-output vectors on the first multioutput update, as the non-windowed
class's do."""

from __future__ import annotations

from typing import Tuple, TypeVar, Union

import torch

from torcheval_tpu_torch.metrics.functional.regression.mean_squared_error import (
    _mean_squared_error_compute,
    _mean_squared_error_param_check,
    _mean_squared_error_update_input_check,
    _update_unweighted,
    _update_weighted,
)
from torcheval_tpu_torch.metrics.window._base import WindowedTaskCounterMetric
from torcheval_tpu_torch.utils.convert import DeviceLike, narrow_64, to_torch_float

TWindowedMeanSquaredError = TypeVar(
    "TWindowedMeanSquaredError", bound="WindowedMeanSquaredError"
)


class WindowedMeanSquaredError(WindowedTaskCounterMetric):
    """MSE over the last ``max_num_updates`` updates; ``compute()``
    returns ``(lifetime, windowed)`` when ``enable_lifetime=True``, else
    the windowed value.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import WindowedMeanSquaredError
    >>> metric = WindowedMeanSquaredError(max_num_updates=2, device="cpu")
    >>> _ = metric.update(torch.tensor([0.9, 0.5]), torch.tensor([0.5, 0.8]))
    >>> _ = metric.update(torch.tensor([0.3, 0.5]), torch.tensor([0.2, 0.8]))
    >>> metric.compute()
    (tensor(0.0875), tensor(0.0875))
    """

    def __init__(
        self,
        *,
        num_tasks: int = 1,
        max_num_updates: int = 100,
        enable_lifetime: bool = True,
        multioutput: str = "uniform_average",
        device: DeviceLike = None,
    ) -> None:
        super().__init__(device=device)
        _mean_squared_error_param_check(multioutput)
        self.multioutput = multioutput
        self._init_window_states(
            ("sum_squared_error", "sum_weight"),
            num_tasks=num_tasks,
            max_num_updates=max_num_updates,
            enable_lifetime=enable_lifetime,
            lifetime_defaults=(torch.zeros(()), torch.zeros(())),
        )

    def _window_input_check(self, input: torch.Tensor) -> None:
        if self.num_tasks == 1:
            if input.ndim > 1:
                raise ValueError(
                    "`num_tasks = 1`, `input` is expected to be "
                    f"one-dimensional tensor, but got shape ({input.shape})."
                )
        elif input.ndim == 1 or input.shape[1] != self.num_tasks:
            raise ValueError(
                f"`num_tasks = {self.num_tasks}`, `input`'s shape is expected "
                f"to be (num_samples, {self.num_tasks}), but got shape "
                f"({input.shape})."
            )

    def update(
        self: TWindowedMeanSquaredError, input, target, *, sample_weight=None
    ) -> TWindowedMeanSquaredError:
        """Write one batch's squared-error sums into the window."""
        return self._apply_update_plan(
            self._update_plan(input, target, sample_weight=sample_weight)
        )

    def _update_plan(self, input, target, *, sample_weight=None):
        input = narrow_64(self._input_float(input))
        target = narrow_64(self._input_float(target))
        if sample_weight is not None:
            sample_weight = narrow_64(to_torch_float(sample_weight, device=self.device))
        _mean_squared_error_update_input_check(input, target, sample_weight)
        self._window_input_check(input)
        if sample_weight is None:
            return self._window_plan(_update_unweighted, (input, target))
        return self._window_plan(_update_weighted, (input, target, sample_weight))

    def compute(self) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """Windowed (and lifetime) MSE; empty before any update."""
        if self.total_updates == 0:
            return self._empty_result()
        sse_sum, weight_sum = self._windowed_counter_sums()
        windowed = _mean_squared_error_compute(sse_sum, self.multioutput, weight_sum).squeeze()
        if self.enable_lifetime:
            lifetime = _mean_squared_error_compute(
                self.sum_squared_error, self.multioutput, self.sum_weight
            ).squeeze()
            return lifetime, windowed
        return windowed
