"""Precision class metrics (counterpart of
``torcheval_tpu/metrics/classification/precision.py``): float32 counter
states with ``SUM`` merge, 0-d under ``average="micro"``."""

from __future__ import annotations

from typing import Optional, TypeVar

import torch

from torcheval_tpu_torch.metrics.functional.classification.precision import (
    _binary_precision_update_input_check,
    _binary_precision_update_jit,
    _precision_compute,
    _precision_param_check,
    _precision_update_input_check,
    _precision_update_jit,
)
from torcheval_tpu_torch.metrics.metric import MergeKind, Metric, UpdatePlan
from torcheval_tpu_torch.utils.convert import DeviceLike

TPrecision = TypeVar("TPrecision", bound="MulticlassPrecision")


class MulticlassPrecision(Metric[torch.Tensor]):
    """Precision for multiclass classification.

    Args:
        num_classes: required unless ``average="micro"``.
        average: ``"micro"``, ``"macro"``, ``"weighted"`` or ``None``.
        device: where the state lives (CUDA by default).

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import MulticlassPrecision
    >>> metric = MulticlassPrecision(device="cpu")
    >>> _ = metric.update(torch.tensor([0, 2, 1, 3]), torch.tensor([0, 1, 2, 3]))
    >>> metric.compute()
    tensor(0.5000)
    """

    def __init__(
        self,
        *,
        num_classes: Optional[int] = None,
        average: Optional[str] = "micro",
        device: DeviceLike = None,
    ) -> None:
        super().__init__(device=device)
        _precision_param_check(num_classes, average)
        self.num_classes = num_classes
        self.average = average
        shape = () if average == "micro" else (num_classes,)
        self._add_state("num_tp", torch.zeros(shape), merge=MergeKind.SUM)
        self._add_state("num_fp", torch.zeros(shape), merge=MergeKind.SUM)
        self._add_state("num_label", torch.zeros(shape), merge=MergeKind.SUM)

    def _update_plan(self, input, target):
        input, target = self._input(input), self._input(target)
        _precision_update_input_check(input, target, self.num_classes)
        return UpdatePlan(
            _precision_update_jit,
            ("num_tp", "num_fp", "num_label"),
            (input, target),
            (self.num_classes, self.average),
        )

    def update(self: TPrecision, input, target) -> TPrecision:
        return self._apply_update_plan(self._update_plan(input, target))

    def compute(self) -> torch.Tensor:
        return _precision_compute(self.num_tp, self.num_fp, self.num_label, self.average)


class BinaryPrecision(MulticlassPrecision):
    """Precision of scores binarized at ``threshold``.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import BinaryPrecision
    >>> metric = BinaryPrecision(device="cpu")
    >>> _ = metric.update(torch.tensor([0.2, 0.8, 0.6, 0.3]), torch.tensor([0, 1, 1, 0]))
    >>> metric.compute()
    tensor(1.)
    """

    def __init__(self, *, threshold: float = 0.5, device: DeviceLike = None) -> None:
        super().__init__(device=device)
        self.threshold = threshold

    def _update_plan(self, input, target):
        input, target = self._input(input), self._input(target)
        _binary_precision_update_input_check(input, target)
        return UpdatePlan(
            _binary_precision_update_jit,
            ("num_tp", "num_fp", "num_label"),
            (input, target),
            (float(self.threshold),),
        )
