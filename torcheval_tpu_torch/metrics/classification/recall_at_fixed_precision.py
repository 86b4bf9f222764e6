"""Recall-at-fixed-precision class metrics over growable example buffers.

Counterpart of ``torcheval_tpu/metrics/classification/
recall_at_fixed_precision.py``: binary and multilabel.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from torcheval_tpu_torch.metrics.classification.auprc import _BufferedPairMetric
from torcheval_tpu_torch.metrics.functional.classification.precision_recall_curve import (
    _multilabel_precision_recall_curve_update_input_check,
)
from torcheval_tpu_torch.metrics.functional.classification.recall_at_fixed_precision import (
    _binary_recall_at_fixed_precision_update_input_check,
    _min_precision_check,
    _rafp_compute,
)
from torcheval_tpu_torch.utils.convert import DeviceLike


class BinaryRecallAtFixedPrecision(_BufferedPairMetric):
    """Max recall such that precision >= ``min_precision``; ``compute``
    returns ``(recall, threshold)``.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import BinaryRecallAtFixedPrecision
    >>> metric = BinaryRecallAtFixedPrecision(min_precision=0.5, device="cpu")
    >>> _ = metric.update(torch.tensor([0.1, 0.4, 0.6, 0.6, 0.6, 0.35, 0.8]),
    ...                   torch.tensor([0, 0, 1, 1, 1, 1, 1]))
    >>> metric.compute()
    (tensor(1.), tensor(0.3500))
    """

    _concat_axis = -1

    def __init__(self, *, min_precision: float, device: DeviceLike = None) -> None:
        super().__init__(device=device)
        _min_precision_check(min_precision)
        self.min_precision = min_precision

    def update(self, input, target) -> "BinaryRecallAtFixedPrecision":
        input, target = self._input(input), self._input(target)
        _binary_recall_at_fixed_precision_update_input_check(
            input, target, self.min_precision
        )
        self._append(input, target)
        return self

    def compute(self) -> Tuple[torch.Tensor, torch.Tensor]:
        # padded slots (score -inf, target -1) only lower the precision of
        # trailing repeated-recall points, never the result
        inputs, targets = self._padded()
        return _rafp_compute(inputs, targets, float(self.min_precision))


class MultilabelRecallAtFixedPrecision(_BufferedPairMetric):
    """Per-label max recall at fixed precision; ``compute`` returns
    ``(recalls, thresholds)`` lists.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import MultilabelRecallAtFixedPrecision
    >>> metric = MultilabelRecallAtFixedPrecision(num_labels=3, min_precision=0.5, device="cpu")
    >>> _ = metric.update(torch.tensor([[0.9, 0.2, 0.8], [0.1, 0.7, 0.3], [0.6, 0.5, 0.4]]),
    ...                   torch.tensor([[1, 0, 1], [0, 1, 0], [1, 0, 1]]))
    >>> metric.compute()[1]
    [tensor(0.6000), tensor(0.7000), tensor(0.4000)]
    """

    def __init__(
        self, *, num_labels: int, min_precision: float, device: DeviceLike = None
    ) -> None:
        super().__init__(device=device)
        _min_precision_check(min_precision)
        self.num_labels = num_labels
        self.min_precision = min_precision

    def update(self, input, target) -> "MultilabelRecallAtFixedPrecision":
        input, target = self._input(input), self._input(target)
        _multilabel_precision_recall_curve_update_input_check(input, target, self.num_labels)
        self._append(input, target)
        return self

    def compute(self) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        inputs, targets = self._padded()
        recalls, thresholds = _rafp_compute(inputs.T, targets.T, float(self.min_precision))
        return list(recalls), list(thresholds)
