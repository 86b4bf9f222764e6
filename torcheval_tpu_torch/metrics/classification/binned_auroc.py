"""Binned AUROC class metrics (counterpart of
``torcheval_tpu/metrics/classification/binned_auroc.py``):

- ``BinaryBinnedAUROC`` and ``MulticlassBinnedAUROC`` buffer examples (the
  curve metrics' growable buffers) and compare them against the whole
  grid at compute;
- ``HistogramBinnedAUROC`` keeps one ``(2T,)`` int32 histogram (negatives
  in ``[0, T)``, positives in ``[T, 2T)``), updated by one
  ``segment_count`` a batch: exact under any merge order, and practical at
  a million thresholds.

Compute returns ``(auroc, threshold)``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from torcheval_tpu_torch.metrics.classification.auprc import _BufferedPairMetric
from torcheval_tpu_torch.metrics.classification.confusion_matrix import _no_shard
from torcheval_tpu_torch.metrics.functional.classification.auroc import (
    _binary_auroc_update_input_check,
    _multiclass_auroc_update_input_check,
)
from torcheval_tpu_torch.metrics.functional.classification.binned_auroc import (
    DEFAULT_NUM_THRESHOLD,
    _binary_binned_auroc_compute_jit,
    _binary_binned_auroc_param_check,
    _hist_binned_auroc_compute,
    _hist_binned_update,
    _multiclass_binned_auroc_compute_jit,
    _multiclass_binned_auroc_param_check,
)
from torcheval_tpu_torch.metrics.functional.classification.binned_precision_recall_curve import (
    ThresholdLike,
)
from torcheval_tpu_torch.metrics.functional.tensor_utils import create_threshold_tensor
from torcheval_tpu_torch.metrics.metric import MergeKind, Metric, UpdatePlan
from torcheval_tpu_torch.utils.convert import DeviceLike, narrow_64


class BinaryBinnedAUROC(_BufferedPairMetric):
    """Binned AUROC for binary classification over buffered examples.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import BinaryBinnedAUROC
    >>> metric = BinaryBinnedAUROC(threshold=5, device="cpu")
    >>> _ = metric.update(torch.tensor([0.1, 0.5, 0.7, 0.8]), torch.tensor([0, 0, 1, 1]))
    >>> metric.compute()[0]
    tensor(0.8750)
    """

    _concat_axis = -1
    _extra_device_attrs = ("threshold",)

    def __init__(
        self,
        *,
        num_tasks: int = 1,
        threshold: ThresholdLike = DEFAULT_NUM_THRESHOLD,
        device: DeviceLike = None,
    ) -> None:
        super().__init__(device=device)
        threshold = create_threshold_tensor(threshold, device=self.device)
        _binary_binned_auroc_param_check(num_tasks, threshold)
        self.num_tasks = num_tasks
        self.threshold = threshold

    def update(self, input, target) -> "BinaryBinnedAUROC":
        input, target = self._input(input), self._input(target)
        _binary_auroc_update_input_check(input, target, self.num_tasks)
        self._append(input, target)
        return self

    def compute(self) -> Tuple[torch.Tensor, torch.Tensor]:
        # padded scores are -inf, below every threshold
        inputs, targets = self._padded()
        return _binary_binned_auroc_compute_jit(inputs, targets, self.threshold), self.threshold


class HistogramBinnedAUROC(Metric[Tuple[torch.Tensor, torch.Tensor]]):
    """Binned AUROC from a per-bin count histogram: O(T) state, O(batch
    log T) updates. Each sample counts in the bin of the last threshold at
    or below its score; compute rebuilds the per-threshold tp/fp by integer
    suffix sums, so the result is bitwise the same however the histogram
    was accumulated or merged. ``shard`` must be ``None``: sharded state is
    not ported yet.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import HistogramBinnedAUROC
    >>> metric = HistogramBinnedAUROC(threshold=4, device="cpu")
    >>> _ = metric.update(torch.tensor([0.1, 0.5, 0.7, 0.8]), torch.tensor([0, 0, 1, 1]))
    >>> metric.compute()[0]
    tensor(1.)
    """

    _extra_device_attrs = ("threshold",)

    def __init__(
        self,
        *,
        threshold: ThresholdLike = DEFAULT_NUM_THRESHOLD,
        device: DeviceLike = None,
        shard=None,
    ) -> None:
        _no_shard(shard, type(self).__name__)
        super().__init__(device=device)
        threshold = create_threshold_tensor(threshold, device=self.device)
        _binary_binned_auroc_param_check(1, threshold)
        self.threshold = threshold
        self.num_thresholds = int(threshold.shape[0])
        self._add_state(
            "hist",
            torch.zeros((2 * self.num_thresholds,), dtype=torch.int32),
            merge=MergeKind.SUM,
        )

    def _update_plan(self, input, target):
        input, target = self._input(input), self._input(target)
        _binary_auroc_update_input_check(input, target, 1)
        return UpdatePlan(_hist_binned_update, ("hist",), (narrow_64(input), target, self.threshold))

    def update(self, input, target) -> "HistogramBinnedAUROC":
        return self._apply_update_plan(self._update_plan(input, target))

    def compute(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return _hist_binned_auroc_compute(self.hist, self.num_thresholds), self.threshold


class MulticlassBinnedAUROC(_BufferedPairMetric):
    """Binned one-vs-rest AUROC for multiclass classification over
    buffered examples, per class or ``"macro"``.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import MulticlassBinnedAUROC
    >>> metric = MulticlassBinnedAUROC(num_classes=3, threshold=5, device="cpu")
    >>> _ = metric.update(torch.tensor([[0.8, 0.1, 0.1], [0.2, 0.7, 0.1],
    ...     [0.1, 0.2, 0.7], [0.3, 0.5, 0.2]]), torch.tensor([0, 1, 2, 1]))
    >>> metric.compute()[0]
    tensor(1.)
    """

    _extra_device_attrs = ("threshold",)

    def __init__(
        self,
        *,
        num_classes: int,
        threshold: ThresholdLike = DEFAULT_NUM_THRESHOLD,
        average: Optional[str] = "macro",
        device: DeviceLike = None,
    ) -> None:
        super().__init__(device=device)
        threshold = create_threshold_tensor(threshold, device=self.device)
        _multiclass_binned_auroc_param_check(num_classes, threshold, average)
        self.num_classes = num_classes
        self.threshold = threshold
        self.average = average

    def update(self, input, target) -> "MulticlassBinnedAUROC":
        input, target = self._input(input), self._input(target)
        _multiclass_auroc_update_input_check(input, target, self.num_classes)
        self._append(input, target)
        return self

    def compute(self) -> Tuple[torch.Tensor, torch.Tensor]:
        auroc = _multiclass_binned_auroc_compute_jit(*self._padded(), self.threshold)
        if self.average == "macro":
            return torch.mean(auroc), self.threshold
        return auroc, self.threshold
