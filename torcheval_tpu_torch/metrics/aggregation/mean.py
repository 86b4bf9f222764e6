"""Mean class metric (counterpart of
``torcheval_tpu/metrics/aggregation/mean.py``)."""

from __future__ import annotations

from typing import TypeVar, Union

import torch

from torcheval_tpu_torch.metrics.functional.aggregation.mean import (
    _scalar_weight_pair,
    _weighted_sum_pair,
)
from torcheval_tpu_torch.metrics.metric import MergeKind, Metric
from torcheval_tpu_torch.utils.convert import DeviceLike, narrow_64, resolve_weight

TMean = TypeVar("TMean", bound="Mean")


class Mean(Metric[torch.Tensor]):
    """Weighted mean of all updated values.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import Mean
    >>> Mean(device="cpu").update(torch.tensor([2., 3.])).compute()
    tensor(2.5000)
    """

    def __init__(self, *, device: DeviceLike = None) -> None:
        super().__init__(device=device)
        self._add_state("weighted_sum", torch.zeros(()), merge=MergeKind.SUM)
        self._add_state("weights", torch.zeros(()), merge=MergeKind.SUM)

    def _update_plan(self, input, *, weight: Union[float, int, torch.Tensor] = 1.0):
        input = narrow_64(self._input_float(input))
        is_scalar, weight_t = resolve_weight(weight, input)
        weight_t = narrow_64(weight_t)
        return (
            _scalar_weight_pair if is_scalar else _weighted_sum_pair,
            ("weighted_sum", "weights"),
            (input, weight_t),
        )

    def update(self: TMean, input, *, weight: Union[float, int, torch.Tensor] = 1.0) -> TMean:
        return self._apply_update_plan(self._update_plan(input, weight=weight))

    def compute(self) -> torch.Tensor:
        return self.weighted_sum / self.weights
