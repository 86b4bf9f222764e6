"""WindowedWeightedCalibration (counterpart of
``torcheval_tpu/metrics/window/weighted_calibration.py``). Unlike the
non-windowed class, the quotient's denominator is clamped at float64's
eps, so a zero target sum gives a large finite value (or 0), not an empty
tensor."""

from __future__ import annotations

from typing import Tuple, TypeVar, Union

import torch

from torcheval_tpu_torch.metrics.functional.ranking.weighted_calibration import (
    _wc_update_scalar,
    _wc_update_tensor,
    _weighted_calibration_input_check,
)
from torcheval_tpu_torch.metrics.window._base import WindowedTaskCounterMetric
from torcheval_tpu_torch.utils.convert import DeviceLike, narrow_64, resolve_weight

TWindowedWeightedCalibration = TypeVar(
    "TWindowedWeightedCalibration", bound="WindowedWeightedCalibration"
)

_EPS = float(torch.finfo(torch.float64).eps)


class WindowedWeightedCalibration(WindowedTaskCounterMetric):
    """Weighted calibration over the last ``max_num_updates`` updates;
    ``compute()`` returns ``(lifetime, windowed)`` when
    ``enable_lifetime=True``, else the windowed value.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import WindowedWeightedCalibration
    >>> metric = WindowedWeightedCalibration(max_num_updates=2,
    ...                                      enable_lifetime=False, device="cpu")
    >>> _ = metric.update(torch.tensor([0.8, 0.4]), torch.tensor([1., 1.]))
    >>> metric.compute()
    tensor([0.6000])
    """

    def __init__(
        self,
        *,
        num_tasks: int = 1,
        max_num_updates: int = 100,
        enable_lifetime: bool = True,
        device: DeviceLike = None,
    ) -> None:
        super().__init__(device=device)
        self._init_window_states(
            ("weighted_input_sum", "weighted_target_sum"),
            num_tasks=num_tasks,
            max_num_updates=max_num_updates,
            enable_lifetime=enable_lifetime,
        )

    def update(
        self: TWindowedWeightedCalibration,
        input,
        target,
        weight: Union[float, int, torch.Tensor] = 1.0,
    ) -> TWindowedWeightedCalibration:
        """Write one batch's weighted sums into the window."""
        return self._apply_update_plan(self._update_plan(input, target, weight))

    def _update_plan(self, input, target, weight: Union[float, int, torch.Tensor] = 1.0):
        input = narrow_64(self._input_float(input))
        target = narrow_64(self._input_float(target))
        if not isinstance(weight, (float, int)):
            weight = narrow_64(self._input_float(weight))
        _weighted_calibration_input_check(input, target, weight, self.num_tasks)
        is_scalar, weight_t = resolve_weight(weight, input)
        kernel = _wc_update_scalar if is_scalar else _wc_update_tensor
        return self._window_plan(kernel, (input, target, weight_t))

    def compute(self) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """Windowed (and lifetime) calibration; empty before any update."""
        if self.total_updates == 0:
            return self._empty_result()
        input_sum, target_sum = self._windowed_counter_sums()
        windowed = input_sum / torch.clamp(target_sum, min=_EPS)
        if self.enable_lifetime:
            lifetime = self.weighted_input_sum / torch.clamp(
                self.weighted_target_sum, min=_EPS
            )
            return lifetime, windowed
        return windowed
