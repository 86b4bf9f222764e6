"""Max class metric (counterpart of
``torcheval_tpu/metrics/aggregation/max.py``)."""

from __future__ import annotations

from typing import TypeVar

import torch

from torcheval_tpu_torch.metrics.functional.tensor_utils import check_reducible
from torcheval_tpu_torch.metrics.metric import MergeKind, Metric, UpdatePlan
from torcheval_tpu_torch.utils.convert import DeviceLike, narrow_64

TMax = TypeVar("TMax", bound="Max")


def _max_transform(states, input):
    """Running maximum: not additive, so a transform plan."""
    return (torch.maximum(states[0], torch.amax(input)),)


class Max(Metric[torch.Tensor]):
    """Running maximum over all elements of all updates.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import Max
    >>> Max(device="cpu").update(torch.tensor([1., 5., 2.])).compute()
    tensor(5.)
    """

    def __init__(self, *, device: DeviceLike = None) -> None:
        super().__init__(device=device)
        self._add_state("max", torch.tensor(-float("inf")), merge=MergeKind.MAX)

    def update(self: TMax, input) -> TMax:
        return self._apply_update_plan(self._update_plan(input))

    def _update_plan(self, input):
        input = narrow_64(self._input_float(input))
        check_reducible(input, "max")
        return UpdatePlan(_max_transform, ("max",), (input,), transform=True)

    def compute(self) -> torch.Tensor:
        return self.max
