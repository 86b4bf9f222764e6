"""F1 score class metrics (counterpart of
``torcheval_tpu/metrics/classification/f1_score.py``: ``MulticlassF1Score``
and ``BinaryF1Score``), O(1) counter states with SUM merge."""

from __future__ import annotations

from typing import Optional, TypeVar

import torch

from torcheval_tpu_torch.metrics.functional.classification.f1_score import (
    _binary_f1_score_update_input_check,
    _binary_f1_score_update_jit,
    _f1_score_compute,
    _f1_score_param_check,
    _f1_score_update_input_check,
    _f1_score_update_jit,
)
from torcheval_tpu_torch.metrics.metric import MergeKind, Metric, UpdatePlan
from torcheval_tpu_torch.utils.convert import DeviceLike

TF1Score = TypeVar("TF1Score", bound="MulticlassF1Score")


class MulticlassF1Score(Metric[torch.Tensor]):
    """F1 score for multiclass classification.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import MulticlassF1Score
    >>> metric = MulticlassF1Score(device="cpu")
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
        _f1_score_param_check(num_classes, average)
        self.num_classes = num_classes
        self.average = average
        shape = () if average == "micro" else (num_classes,)
        self._add_state("num_tp", torch.zeros(shape), merge=MergeKind.SUM)
        self._add_state("num_label", torch.zeros(shape), merge=MergeKind.SUM)
        self._add_state("num_prediction", torch.zeros(shape), merge=MergeKind.SUM)

    def _update_plan(self, input, target):
        input, target = self._input(input), self._input(target)
        _f1_score_update_input_check(input, target, self.num_classes)
        return UpdatePlan(
            _f1_score_update_jit,
            ("num_tp", "num_label", "num_prediction"),
            (input, target),
            (self.num_classes, self.average),
        )

    def update(self: TF1Score, input, target) -> TF1Score:
        return self._apply_update_plan(self._update_plan(input, target))

    def compute(self) -> torch.Tensor:
        return _f1_score_compute(
            self.num_tp, self.num_label, self.num_prediction, self.average
        )


class BinaryF1Score(MulticlassF1Score):
    """Binary F1 score with thresholded score inputs.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import BinaryF1Score
    >>> metric = BinaryF1Score(device="cpu")
    >>> _ = metric.update(torch.tensor([0.2, 0.8, 0.6, 0.3]), torch.tensor([0, 1, 1, 0]))
    >>> metric.compute()
    tensor(1.)
    """

    def __init__(self, *, threshold: float = 0.5, device: DeviceLike = None) -> None:
        super().__init__(device=device)
        self.threshold = threshold

    def _update_plan(self, input, target):
        input, target = self._input(input), self._input(target)
        _binary_f1_score_update_input_check(input, target)
        return UpdatePlan(
            _binary_f1_score_update_jit,
            ("num_tp", "num_label", "num_prediction"),
            (input, target),
            (float(self.threshold),),
        )
