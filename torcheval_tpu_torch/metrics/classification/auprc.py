"""AUPRC class metrics over growable example buffers.

Counterpart of ``torcheval_tpu/metrics/classification/auprc.py``:
``_BufferedPairMetric`` (the shared (inputs, targets) buffers of the curve
metrics), ``BinaryAUPRC``, ``MulticlassAUPRC`` and ``MultilabelAUPRC``.
"""

from __future__ import annotations

from typing import Optional

import torch

from torcheval_tpu_torch.metrics._buffer import BufferedExamplesMetric
from torcheval_tpu_torch.metrics.functional.classification.auprc import (
    _average,
    _binary_auprc_compute,
    _binary_auprc_update_input_check,
    _multiclass_auprc_compute,
    _multiclass_auprc_param_check,
    _multiclass_auprc_update_input_check,
    _multilabel_auprc_compute,
    _multilabel_auprc_param_check,
    _multilabel_auprc_update_input_check,
)
from torcheval_tpu_torch.utils.convert import DeviceLike


class _BufferedPairMetric(BufferedExamplesMetric):
    """Buffered (inputs, targets) for the curve metrics: padded scores are
    ``-inf`` (after every real score), padded targets ``-1`` (no class, no
    positive label), so the curve computations take the whole padded
    buffer."""

    _concat_axis = 0  # sample axis of update batches
    _target_fill = -1.0

    def __init__(self, *, device: DeviceLike = None) -> None:
        super().__init__(device=device)
        self._add_buffer("inputs", fill=float("-inf"), axis=self._concat_axis)
        self._add_buffer("targets", fill=self._target_fill, axis=self._concat_axis)

    def _append(self, input: torch.Tensor, target: torch.Tensor) -> None:
        BufferedExamplesMetric._append(self, inputs=input, targets=target)


class BinaryAUPRC(_BufferedPairMetric):
    """AUPRC (average precision by Riemann sum) for binary classification.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import BinaryAUPRC
    >>> metric = BinaryAUPRC(device="cpu")
    >>> _ = metric.update(torch.tensor([0.1, 0.5, 0.7, 0.8]), torch.tensor([1, 0, 1, 1]))
    >>> metric.compute()
    tensor(0.9167)
    """

    _concat_axis = -1

    def __init__(self, *, num_tasks: int = 1, device: DeviceLike = None) -> None:
        super().__init__(device=device)
        if num_tasks < 1:
            raise ValueError(
                "`num_tasks` value should be greater than and equal to 1, "
                f"but received {num_tasks}. "
            )
        self.num_tasks = num_tasks

    def update(self, input, target) -> "BinaryAUPRC":
        input, target = self._input(input), self._input(target)
        _binary_auprc_update_input_check(input, target, self.num_tasks)
        self._append(input, target)
        return self

    def compute(self) -> torch.Tensor:
        # padded entries (score -inf, target -1) add no true positive and
        # only trailing zero-width Riemann segments
        return _binary_auprc_compute(*self._padded())


class MulticlassAUPRC(_BufferedPairMetric):
    """One-vs-rest AUPRC for multiclass classification.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import MulticlassAUPRC
    >>> metric = MulticlassAUPRC(num_classes=3, device="cpu")
    >>> _ = metric.update(torch.tensor([[0.8, 0.1, 0.1], [0.2, 0.7, 0.1],
    ...                   [0.1, 0.2, 0.7], [0.3, 0.5, 0.2]]), torch.tensor([0, 1, 2, 1]))
    >>> metric.compute()
    tensor(1.)
    """

    def __init__(
        self,
        *,
        num_classes: int,
        average: Optional[str] = "macro",
        device: DeviceLike = None,
    ) -> None:
        super().__init__(device=device)
        _multiclass_auprc_param_check(num_classes, average)
        self.num_classes = num_classes
        self.average = average

    def update(self, input, target) -> "MulticlassAUPRC":
        input, target = self._input(input), self._input(target)
        _multiclass_auprc_update_input_check(input, target, self.num_classes)
        self._append(input, target)
        return self

    def compute(self) -> torch.Tensor:
        return _average(_multiclass_auprc_compute(*self._padded()), self.average)


class MultilabelAUPRC(_BufferedPairMetric):
    """Per-label AUPRC for multilabel classification.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import MultilabelAUPRC
    >>> metric = MultilabelAUPRC(num_labels=3, device="cpu")
    >>> _ = metric.update(torch.tensor([[0.9, 0.2, 0.8], [0.1, 0.7, 0.3], [0.6, 0.5, 0.4]]),
    ...                   torch.tensor([[1, 0, 1], [0, 1, 0], [1, 0, 1]]))
    >>> metric.compute()
    tensor(1.)
    """

    def __init__(
        self,
        *,
        num_labels: int,
        average: Optional[str] = "macro",
        device: DeviceLike = None,
    ) -> None:
        super().__init__(device=device)
        _multilabel_auprc_param_check(num_labels, average)
        self.num_labels = num_labels
        self.average = average

    def update(self, input, target) -> "MultilabelAUPRC":
        input, target = self._input(input), self._input(target)
        _multilabel_auprc_update_input_check(input, target, self.num_labels)
        self._append(input, target)
        return self

    def compute(self) -> torch.Tensor:
        return _average(_multilabel_auprc_compute(*self._padded()), self.average)
