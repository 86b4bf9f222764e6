"""ClickThroughRate class metric (counterpart of
``torcheval_tpu/metrics/ranking/click_through_rate.py``): per-task
float32 ``click_total`` and ``weight_total``, ``SUM``-merged."""

from __future__ import annotations

from typing import TypeVar, Union

import torch

from torcheval_tpu_torch.metrics.functional.ranking.click_through_rate import (
    _click_through_rate_compute,
    resolve_ctr_weights,
)
from torcheval_tpu_torch.metrics.metric import MergeKind, Metric
from torcheval_tpu_torch.utils.convert import DeviceLike, narrow_64

TClickThroughRate = TypeVar("TClickThroughRate", bound="ClickThroughRate")


class ClickThroughRate(Metric[torch.Tensor]):
    """Weighted click-through rate, optionally multi-task.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import ClickThroughRate
    >>> metric = ClickThroughRate(device="cpu")
    >>> _ = metric.update(torch.tensor([0, 1, 0, 1, 1, 0, 0, 1]))
    >>> metric.compute()
    tensor([0.5000])
    """

    def __init__(self, *, num_tasks: int = 1, device: DeviceLike = None) -> None:
        super().__init__(device=device)
        if num_tasks < 1:
            raise ValueError(
                "`num_tasks` value should be greater than and equal to 1, "
                f"but received {num_tasks}. "
            )
        self.num_tasks = num_tasks
        self._add_state("click_total", torch.zeros(num_tasks), merge=MergeKind.SUM)
        self._add_state("weight_total", torch.zeros(num_tasks), merge=MergeKind.SUM)

    def _update_plan(self, input, weights: Union[torch.Tensor, float, int] = 1.0):
        kernel, args = resolve_ctr_weights(
            narrow_64(self._input(input)),
            weights,
            num_tasks=self.num_tasks,
            convert=self._input_float,
        )
        return (kernel, ("click_total", "weight_total"), args, ())

    def update(
        self: TClickThroughRate,
        input,
        weights: Union[torch.Tensor, float, int] = 1.0,
    ) -> TClickThroughRate:
        """Accumulate click events (and optional per-event weights)."""
        return self._apply_update_plan(self._update_plan(input, weights))

    def compute(self) -> torch.Tensor:
        """CTR per task; 0.0 for a task with no weight."""
        return _click_through_rate_compute(self.click_total, self.weight_total)
