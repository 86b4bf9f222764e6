"""AUROC class metrics over growable example buffers.

Counterpart of ``torcheval_tpu/metrics/classification/auroc.py`` (:32-134):
``BinaryAUROC`` (multi-task, weighted, optional fused kernel) and
``MulticlassAUROC``, both ``BufferedExamplesMetric``s (``metrics/_buffer.py``)
that compute on their padded buffers: padded scores are ``-inf`` and sort
last, padded weights are 0.
"""

from __future__ import annotations

from typing import Optional, TypeVar

import torch

from torcheval_tpu_torch.metrics._buffer import BufferedExamplesMetric
from torcheval_tpu_torch.metrics.functional.classification.auroc import (
    _binary_auroc_compute,
    _binary_auroc_update_input_check,
    _multiclass_auroc_compute,
    _multiclass_auroc_param_check,
    _multiclass_auroc_update_input_check,
)
from torcheval_tpu_torch.utils.convert import DeviceLike

TBinaryAUROC = TypeVar("TBinaryAUROC", bound="BinaryAUROC")
TMulticlassAUROC = TypeVar("TMulticlassAUROC", bound="MulticlassAUROC")


class BinaryAUROC(BufferedExamplesMetric):
    """AUROC for binary classification (optionally multi-task, weighted).

    Args:
        num_tasks: number of independent tasks (rows of the input).
        use_fused: compute with the sort-free histogram kernel
            (``ops.fused_auc``), exact up to its bin resolution;
            ``use_fbgemm`` is accepted as an alias.
        device: where the buffers live (CUDA by default).

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import BinaryAUROC
    >>> metric = BinaryAUROC(device="cpu")
    >>> _ = metric.update(torch.tensor([0.1, 0.5, 0.7, 0.8]), torch.tensor([0, 0, 1, 1]))
    >>> metric.compute()
    tensor(1.)
    """

    def __init__(
        self,
        *,
        num_tasks: int = 1,
        device: DeviceLike = None,
        use_fused: bool = False,
        use_fbgemm: Optional[bool] = None,
    ) -> None:
        super().__init__(device=device)
        if num_tasks < 1:
            raise ValueError(
                "`num_tasks` value should be greater than and equal to 1, "
                f"but received {num_tasks}. "
            )
        self.num_tasks = num_tasks
        self.use_fused = use_fused if use_fbgemm is None else use_fbgemm
        self._add_buffer("inputs", fill=float("-inf"), axis=-1)
        self._add_buffer("targets", fill=0.0, axis=-1)
        self._add_buffer("weights", fill=0.0, axis=-1)

    def update(self: TBinaryAUROC, input, target, *, weight=None) -> TBinaryAUROC:
        input, target = self._input(input), self._input(target)
        weight = self._input(weight) if weight is not None else None
        _binary_auroc_update_input_check(input, target, self.num_tasks, weight)
        if weight is None:
            weight = torch.ones(input.shape, dtype=torch.float32, device=self.device)
        BufferedExamplesMetric._append(self, inputs=input, targets=target, weights=weight)
        return self

    def compute(self) -> torch.Tensor:
        if self.use_fused:
            # the histogram kernel min/max-normalizes the scores it is
            # given, so it takes the valid samples, not the -inf padding
            inputs, targets, weights = self._valid()
        else:
            inputs, targets, weights = self._padded()
        return _binary_auroc_compute(inputs, targets, weights, self.use_fused)


class MulticlassAUROC(BufferedExamplesMetric):
    """One-vs-rest AUROC for multiclass classification.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import MulticlassAUROC
    >>> metric = MulticlassAUROC(num_classes=2, device="cpu")
    >>> _ = metric.update(torch.tensor([[0.1, 0.1], [0.5, 0.5]]), torch.tensor([0, 1]))
    >>> metric.compute()
    tensor(0.5000)
    """

    def __init__(
        self,
        *,
        num_classes: int,
        average: Optional[str] = "macro",
        device: DeviceLike = None,
    ) -> None:
        super().__init__(device=device)
        _multiclass_auroc_param_check(num_classes, average)
        self.num_classes = num_classes
        self.average = average
        # padded rows: score -inf (sorts last in every class), target -1
        # (no class); compute also gives them weight 0 through the mask
        self._add_buffer("inputs", fill=float("-inf"), axis=0)
        self._add_buffer("targets", fill=-1.0, axis=0)

    def update(self: TMulticlassAUROC, input, target) -> TMulticlassAUROC:
        input, target = self._input(input), self._input(target)
        _multiclass_auroc_update_input_check(input, target, self.num_classes)
        BufferedExamplesMetric._append(self, inputs=input, targets=target)
        return self

    def compute(self) -> torch.Tensor:
        inputs, targets = self._padded()
        aurocs = _multiclass_auroc_compute(
            inputs, targets, self._valid_mask(inputs.shape[0])
        )
        if self.average == "macro":
            return torch.mean(aurocs)
        return aurocs
