"""Sum class metric (counterpart of
``torcheval_tpu/metrics/aggregation/sum.py``)."""

from __future__ import annotations

from typing import TypeVar, Union

import torch

from torcheval_tpu_torch.metrics.functional.aggregation.sum import _weighted_total
from torcheval_tpu_torch.metrics.metric import MergeKind, Metric
from torcheval_tpu_torch.utils.convert import DeviceLike, narrow_64, resolve_weight

TSum = TypeVar("TSum", bound="Sum")


class Sum(Metric[torch.Tensor]):
    """Weighted sum of all updated values.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import Sum
    >>> Sum(device="cpu").update(torch.tensor([2., 3.])).compute()
    tensor(5.)
    """

    def __init__(self, *, device: DeviceLike = None) -> None:
        super().__init__(device=device)
        self._add_state("weighted_sum", torch.zeros(()), merge=MergeKind.SUM)

    def _update_plan(self, input, *, weight=1.0):
        input = narrow_64(self._input_float(input))
        _, weight_t = resolve_weight(weight, input, int_clause=True)
        weight_t = narrow_64(weight_t)
        return (_weighted_total, ("weighted_sum",), (input, weight_t), ())

    def update(self: TSum, input, *, weight: Union[float, int, torch.Tensor] = 1.0) -> TSum:
        return self._apply_update_plan(self._update_plan(input, weight=weight))

    def compute(self) -> torch.Tensor:
        return self.weighted_sum
