"""Binned AUPRC class metrics (counterpart of
``torcheval_tpu/metrics/classification/binned_auprc.py``): the binned
precision-recall counters as state (float32, ``SUM`` merge), integrated at
compute. Compute returns the AUPRC alone, without the thresholds."""

from __future__ import annotations

from typing import Optional

import torch

from torcheval_tpu_torch.metrics.classification.binned_precision_recall_curve import (
    _BinnedCounters,
)
from torcheval_tpu_torch.metrics.functional.classification.auprc import (
    _binary_auprc_update_input_check,
    _multiclass_auprc_update_input_check,
    _multilabel_auprc_update_input_check,
)
from torcheval_tpu_torch.metrics.functional.classification.binned_auprc import (
    DEFAULT_NUM_THRESHOLD,
    _binary_binned_auprc_param_check,
    _binned_auprc_from_counts,
    _macro,
    _multiclass_binned_auprc_param_check,
    _multilabel_binned_auprc_param_check,
)
from torcheval_tpu_torch.metrics.functional.classification.binned_precision_recall_curve import (
    ThresholdLike,
    _binary_binned_update_jit,
    _MULTICLASS_KERNELS,
    _MULTILABEL_KERNELS,
    _optimization_param_check,
)
from torcheval_tpu_torch.metrics.functional.tensor_utils import create_threshold_tensor
from torcheval_tpu_torch.utils.convert import DeviceLike


class BinaryBinnedAUPRC(_BinnedCounters):
    """Binned AUPRC for binary classification, one row of (T,) counters a
    task.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import BinaryBinnedAUPRC
    >>> metric = BinaryBinnedAUPRC(threshold=5, device="cpu")
    >>> _ = metric.update(torch.tensor([0.1, 0.5, 0.7, 0.8]), torch.tensor([1, 0, 1, 1]))
    >>> metric.compute()
    tensor(0.8056)
    """

    def __init__(
        self,
        *,
        num_tasks: int = 1,
        threshold: ThresholdLike = DEFAULT_NUM_THRESHOLD,
        device: DeviceLike = None,
    ) -> None:
        super().__init__(device=device)
        threshold = create_threshold_tensor(threshold, span=True, device=self.device)
        _binary_binned_auprc_param_check(num_tasks, threshold)
        self.num_tasks = num_tasks
        num_t = threshold.shape[0]
        self._add_counters(threshold, (num_t,) if num_tasks == 1 else (num_tasks, num_t))

    def _update_plan(self, input, target):
        input, target = self._input(input), self._input(target)
        _binary_auprc_update_input_check(input, target, self.num_tasks)
        if self.num_tasks == 1:
            # the (1, n) form counts into the (T,) state, not a (1, T) one
            input, target = input.reshape(-1), target.reshape(-1)
        return self._counter_plan(_binary_binned_update_jit, input, target)

    def compute(self) -> torch.Tensor:
        return _binned_auprc_from_counts(self.num_tp, self.num_fp, self.num_fn)


class MulticlassBinnedAUPRC(_BinnedCounters):
    """Binned one-vs-rest AUPRC for multiclass classification, averaged
    ``"macro"`` or per class (``None``/``"none"``).

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import MulticlassBinnedAUPRC
    >>> metric = MulticlassBinnedAUPRC(num_classes=3, threshold=5, device="cpu")
    >>> _ = metric.update(torch.tensor([[0.8, 0.1, 0.1], [0.2, 0.7, 0.1],
    ...     [0.1, 0.2, 0.7], [0.3, 0.5, 0.2]]), torch.tensor([0, 1, 2, 1]))
    >>> metric.compute()
    tensor(1.)
    """

    def __init__(
        self,
        *,
        num_classes: int,
        threshold: ThresholdLike = DEFAULT_NUM_THRESHOLD,
        average: Optional[str] = "macro",
        optimization: str = "vectorized",
        device: DeviceLike = None,
    ) -> None:
        super().__init__(device=device)
        threshold = create_threshold_tensor(threshold, span=True, device=self.device)
        _multiclass_binned_auprc_param_check(num_classes, threshold, average)
        _optimization_param_check(optimization)
        self.num_classes = num_classes
        self.average = average
        self.optimization = optimization
        self._add_counters(threshold, (threshold.shape[0], num_classes))

    def _update_plan(self, input, target):
        input, target = self._input(input), self._input(target)
        _multiclass_auprc_update_input_check(input, target, self.num_classes)
        return self._counter_plan(_MULTICLASS_KERNELS[self.optimization], input, target)

    def compute(self) -> torch.Tensor:
        auprc = _binned_auprc_from_counts(self.num_tp.T, self.num_fp.T, self.num_fn.T)
        return _macro(auprc, self.average)


class MultilabelBinnedAUPRC(_BinnedCounters):
    """Binned AUPRC per label for multilabel classification, averaged
    ``"macro"`` or per label.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import MultilabelBinnedAUPRC
    >>> metric = MultilabelBinnedAUPRC(num_labels=3, threshold=5, device="cpu")
    >>> _ = metric.update(torch.tensor([[0.9, 0.2, 0.8], [0.1, 0.7, 0.3], [0.6, 0.5, 0.4]]),
    ...                   torch.tensor([[1, 0, 1], [0, 1, 0], [1, 0, 1]]))
    >>> metric.compute()
    tensor(0.7778)
    """

    def __init__(
        self,
        *,
        num_labels: int,
        threshold: ThresholdLike = DEFAULT_NUM_THRESHOLD,
        average: Optional[str] = "macro",
        optimization: str = "vectorized",
        device: DeviceLike = None,
    ) -> None:
        super().__init__(device=device)
        threshold = create_threshold_tensor(threshold, span=True, device=self.device)
        _multilabel_binned_auprc_param_check(num_labels, threshold, average)
        _optimization_param_check(optimization)
        self.num_labels = num_labels
        self.average = average
        self.optimization = optimization
        self._add_counters(threshold, (threshold.shape[0], num_labels))

    def _update_plan(self, input, target):
        input, target = self._input(input), self._input(target)
        _multilabel_auprc_update_input_check(input, target, self.num_labels)
        return self._counter_plan(_MULTILABEL_KERNELS[self.optimization], input, target)

    def compute(self) -> torch.Tensor:
        auprc = _binned_auprc_from_counts(self.num_tp.T, self.num_fp.T, self.num_fn.T)
        return _macro(auprc, self.average)
