"""WindowedClickThroughRate (counterpart of
``torcheval_tpu/metrics/window/click_through_rate.py``)."""

from __future__ import annotations

from typing import Tuple, TypeVar, Union

import torch

from torcheval_tpu_torch.metrics.classification.confusion_matrix import _no_shard
from torcheval_tpu_torch.metrics.functional.ranking.click_through_rate import (
    _click_through_rate_compute,
    resolve_ctr_weights,
)
from torcheval_tpu_torch.metrics.window._base import WindowedTaskCounterMetric
from torcheval_tpu_torch.utils.convert import DeviceLike, narrow_64

TWindowedClickThroughRate = TypeVar(
    "TWindowedClickThroughRate", bound="WindowedClickThroughRate"
)


class WindowedClickThroughRate(WindowedTaskCounterMetric):
    """CTR over the last ``max_num_updates`` updates (and, optionally,
    over all of them); ``compute()`` returns ``(lifetime, windowed)`` when
    ``enable_lifetime=True``, else the windowed value.

    Args:
        shard: only ``None`` (sharded state is not ported yet).

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import WindowedClickThroughRate
    >>> metric = WindowedClickThroughRate(max_num_updates=2, device="cpu")
    >>> _ = metric.update(torch.tensor([0., 1., 1., 1.]))
    >>> _ = metric.update(torch.tensor([0., 1., 0., 1.]))
    >>> _ = metric.update(torch.tensor([0., 0., 0., 1.]))
    >>> metric.compute()
    (tensor([0.5000]), tensor([0.3750]))
    """

    def __init__(
        self,
        *,
        num_tasks: int = 1,
        max_num_updates: int = 100,
        enable_lifetime: bool = True,
        device: DeviceLike = None,
        shard=None,
    ) -> None:
        _no_shard(shard, "WindowedClickThroughRate")
        super().__init__(device=device)
        self._init_window_states(
            ("click_total", "weight_total"),
            num_tasks=num_tasks,
            max_num_updates=max_num_updates,
            enable_lifetime=enable_lifetime,
        )

    def update(
        self: TWindowedClickThroughRate,
        input,
        weights: Union[torch.Tensor, float, int] = 1.0,
    ) -> TWindowedClickThroughRate:
        """Write one update's click events into the window."""
        return self._apply_update_plan(self._update_plan(input, weights))

    def _update_plan(self, input, weights: Union[torch.Tensor, float, int] = 1.0):
        kernel, args = resolve_ctr_weights(
            narrow_64(self._input(input)),
            weights,
            num_tasks=self.num_tasks,
            convert=self._input_float,
        )
        return self._window_plan(kernel, args)

    def compute(self) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """Windowed (and lifetime) CTR per task; empty before any update."""
        if self.total_updates == 0:
            return self._empty_result()
        click_sum, weight_sum = self._windowed_counter_sums()
        windowed = _click_through_rate_compute(click_sum, weight_sum)
        if self.enable_lifetime:
            lifetime = _click_through_rate_compute(self.click_total, self.weight_total)
            return lifetime, windowed
        return windowed
