"""Precision-recall curve class metrics over growable example buffers.

Counterpart of ``torcheval_tpu/metrics/classification/
precision_recall_curve.py``: binary, multiclass and multilabel. Each
computes on its padded buffers and drops the padded points before the tie
compaction.
"""

from __future__ import annotations

from typing import Optional

from torcheval_tpu_torch.metrics.classification.auprc import _BufferedPairMetric
from torcheval_tpu_torch.metrics.functional.classification.precision_recall_curve import (
    Curve,
    Curves,
    _binary_precision_recall_curve_compute,
    _binary_precision_recall_curve_update_input_check,
    _multiclass_precision_recall_curve_compute,
    _multiclass_precision_recall_curve_update_input_check,
    _multilabel_precision_recall_curve_compute,
    _multilabel_precision_recall_curve_update_input_check,
)
from torcheval_tpu_torch.utils.convert import DeviceLike


class BinaryPrecisionRecallCurve(_BufferedPairMetric):
    """Precision-recall curve for binary classification; ``compute``
    returns ``(precision, recall, thresholds)``.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import BinaryPrecisionRecallCurve
    >>> metric = BinaryPrecisionRecallCurve(device="cpu")
    >>> _ = metric.update(torch.tensor([0.1, 0.5, 0.7, 0.8]), torch.tensor([0, 0, 1, 1]))
    >>> metric.compute()[2]
    tensor([0.1000, 0.5000, 0.7000, 0.8000])
    """

    _concat_axis = -1

    def update(self, input, target) -> "BinaryPrecisionRecallCurve":
        input, target = self._input(input), self._input(target)
        _binary_precision_recall_curve_update_input_check(input, target)
        self._append(input, target)
        return self

    def compute(self) -> Curve:
        inputs, targets = self._padded()
        return _binary_precision_recall_curve_compute(
            inputs, targets, valid_count=self.num_samples
        )


class MulticlassPrecisionRecallCurve(_BufferedPairMetric):
    """Per-class precision-recall curves for multiclass classification.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import MulticlassPrecisionRecallCurve
    >>> metric = MulticlassPrecisionRecallCurve(num_classes=3, device="cpu")
    >>> _ = metric.update(torch.tensor([[0.8, 0.1, 0.1], [0.2, 0.7, 0.1],
    ...                   [0.1, 0.2, 0.7], [0.3, 0.5, 0.2]]), torch.tensor([0, 1, 2, 1]))
    >>> metric.compute()[1][1]
    tensor([1.0000, 1.0000, 1.0000, 0.5000, 0.0000])
    """

    def __init__(
        self, *, num_classes: Optional[int] = None, device: DeviceLike = None
    ) -> None:
        super().__init__(device=device)
        self.num_classes = num_classes

    def update(self, input, target) -> "MulticlassPrecisionRecallCurve":
        input, target = self._input(input), self._input(target)
        _multiclass_precision_recall_curve_update_input_check(input, target, self.num_classes)
        self._append(input, target)
        return self

    def compute(self) -> Curves:
        inputs, targets = self._padded()
        num_classes = self.num_classes if self.num_classes is not None else inputs.shape[1]
        return _multiclass_precision_recall_curve_compute(
            inputs, targets, num_classes, valid_count=self.num_samples
        )


class MultilabelPrecisionRecallCurve(_BufferedPairMetric):
    """Per-label precision-recall curves for multilabel classification.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import MultilabelPrecisionRecallCurve
    >>> metric = MultilabelPrecisionRecallCurve(num_labels=3, device="cpu")
    >>> _ = metric.update(torch.tensor([[0.9, 0.2, 0.8], [0.1, 0.7, 0.3], [0.6, 0.5, 0.4]]),
    ...                   torch.tensor([[1, 0, 1], [0, 1, 0], [1, 0, 1]]))
    >>> metric.compute()[2][0]
    tensor([0.1000, 0.6000, 0.9000])
    """

    def __init__(
        self, *, num_labels: Optional[int] = None, device: DeviceLike = None
    ) -> None:
        super().__init__(device=device)
        self.num_labels = num_labels

    def update(self, input, target) -> "MultilabelPrecisionRecallCurve":
        input, target = self._input(input), self._input(target)
        _multilabel_precision_recall_curve_update_input_check(input, target, self.num_labels)
        self._append(input, target)
        return self

    def compute(self) -> Curves:
        inputs, targets = self._padded()
        return _multilabel_precision_recall_curve_compute(
            inputs, targets, valid_count=self.num_samples
        )
