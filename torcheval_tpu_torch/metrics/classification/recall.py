"""Recall class metrics (counterpart of
``torcheval_tpu/metrics/classification/recall.py``): float32 counter
states with ``SUM`` merge, 0-d under ``average="micro"``;
``BinaryRecall`` is its own class with two counters."""

from __future__ import annotations

from typing import Optional, TypeVar

import torch

from torcheval_tpu_torch.metrics.functional.classification.recall import (
    _binary_recall_update_input_check,
    _binary_recall_update_jit,
    _recall_compute,
    _recall_param_check,
    _recall_update_input_check,
    _recall_update_jit,
)
from torcheval_tpu_torch.metrics.functional.tensor_utils import nan_safe_divide
from torcheval_tpu_torch.metrics.metric import MergeKind, Metric, UpdatePlan
from torcheval_tpu_torch.utils.convert import DeviceLike

TRecall = TypeVar("TRecall", bound="MulticlassRecall")


class MulticlassRecall(Metric[torch.Tensor]):
    """Recall for multiclass classification.

    Args:
        num_classes: required unless ``average="micro"``.
        average: ``"micro"``, ``"macro"``, ``"weighted"`` or ``None``.
        device: where the state lives (CUDA by default).

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import MulticlassRecall
    >>> metric = MulticlassRecall(device="cpu")
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
        _recall_param_check(num_classes, average)
        self.num_classes = num_classes
        self.average = average
        shape = () if average == "micro" else (num_classes,)
        self._add_state("num_tp", torch.zeros(shape), merge=MergeKind.SUM)
        self._add_state("num_labels", torch.zeros(shape), merge=MergeKind.SUM)
        self._add_state("num_predictions", torch.zeros(shape), merge=MergeKind.SUM)

    def _update_plan(self, input, target):
        input, target = self._input(input), self._input(target)
        _recall_update_input_check(input, target, self.num_classes)
        return UpdatePlan(
            _recall_update_jit,
            ("num_tp", "num_labels", "num_predictions"),
            (input, target),
            (self.num_classes, self.average),
        )

    def update(self: TRecall, input, target) -> TRecall:
        return self._apply_update_plan(self._update_plan(input, target))

    def compute(self) -> torch.Tensor:
        return _recall_compute(self.num_tp, self.num_labels, self.num_predictions, self.average)


class BinaryRecall(Metric[torch.Tensor]):
    """Recall of scores binarized at ``threshold``.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import BinaryRecall
    >>> metric = BinaryRecall(device="cpu")
    >>> _ = metric.update(torch.tensor([0.9, 0.2, 0.6, 0.1]), torch.tensor([1, 0, 1, 1]))
    >>> metric.compute()
    tensor(0.6667)
    """

    def __init__(self, *, threshold: float = 0.5, device: DeviceLike = None) -> None:
        super().__init__(device=device)
        self.threshold = threshold
        self._add_state("num_tp", torch.zeros(()), merge=MergeKind.SUM)
        self._add_state("num_true_labels", torch.zeros(()), merge=MergeKind.SUM)

    def _update_plan(self, input, target):
        input, target = self._input(input), self._input(target)
        _binary_recall_update_input_check(input, target)
        return UpdatePlan(
            _binary_recall_update_jit,
            ("num_tp", "num_true_labels"),
            (input, target),
            (float(self.threshold),),
        )

    def update(self, input, target) -> "BinaryRecall":
        return self._apply_update_plan(self._update_plan(input, target))

    def compute(self) -> torch.Tensor:
        return torch.nan_to_num(nan_safe_divide(self.num_tp, self.num_true_labels))
