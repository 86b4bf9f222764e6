"""Min class metric (counterpart of
``torcheval_tpu/metrics/aggregation/min.py``)."""

from __future__ import annotations

from typing import TypeVar

import torch

from torcheval_tpu_torch.metrics.functional.tensor_utils import check_reducible
from torcheval_tpu_torch.metrics.metric import MergeKind, Metric, UpdatePlan
from torcheval_tpu_torch.utils.convert import DeviceLike, narrow_64

TMin = TypeVar("TMin", bound="Min")


def _min_transform(states, input):
    """Running minimum: not additive, so a transform plan."""
    return (torch.minimum(states[0], torch.amin(input)),)


class Min(Metric[torch.Tensor]):
    """Running minimum over all elements of all updates.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import Min
    >>> Min(device="cpu").update(torch.tensor([1., 5., 2.])).compute()
    tensor(1.)
    """

    def __init__(self, *, device: DeviceLike = None) -> None:
        super().__init__(device=device)
        self._add_state("min", torch.tensor(float("inf")), merge=MergeKind.MIN)

    def update(self: TMin, input) -> TMin:
        return self._apply_update_plan(self._update_plan(input))

    def _update_plan(self, input):
        input = narrow_64(self._input_float(input))
        check_reducible(input, "min")
        return UpdatePlan(_min_transform, ("min",), (input,), transform=True)

    def compute(self) -> torch.Tensor:
        return self.min
