"""Binned precision-recall curve class metrics (counterpart of
``torcheval_tpu/metrics/classification/binned_precision_recall_curve.py``):
float32 ``(T,)`` or ``(T, C)`` counters with ``SUM`` merge, so replicas
sync by one sum instead of shipping examples."""

from __future__ import annotations

from typing import List, Tuple

import torch

from torcheval_tpu_torch.metrics.functional.classification.binned_precision_recall_curve import (
    DEFAULT_NUM_THRESHOLD,
    ThresholdLike,
    _binary_binned_compute_jit,
    _binary_binned_update_jit,
    _MULTICLASS_KERNELS,
    _multiclass_binned_precision_recall_curve_compute,
    _MULTILABEL_KERNELS,
    _optimization_param_check,
)
from torcheval_tpu_torch.metrics.functional.classification.precision_recall_curve import (
    _binary_precision_recall_curve_update_input_check,
    _multiclass_precision_recall_curve_update_input_check,
    _multilabel_precision_recall_curve_update_input_check,
)
from torcheval_tpu_torch.metrics.functional.tensor_utils import create_threshold_tensor
from torcheval_tpu_torch.metrics.metric import MergeKind, Metric, UpdatePlan
from torcheval_tpu_torch.utils.convert import DeviceLike, narrow_64


class _BinnedCounters(Metric):
    """``num_tp``/``num_fp``/``num_fn`` float32 counters of ``shape`` over
    the threshold grid ``self.threshold`` (on the metric's device)."""

    _extra_device_attrs = ("threshold",)

    def _add_counters(self, threshold: torch.Tensor, shape: tuple) -> None:
        self.threshold = threshold
        for name in ("num_tp", "num_fp", "num_fn"):
            self._add_state(name, torch.zeros(shape), merge=MergeKind.SUM)

    def _counter_plan(self, kernel, input, target) -> UpdatePlan:
        return UpdatePlan(
            kernel, ("num_tp", "num_fp", "num_fn"), (narrow_64(input), target, self.threshold)
        )

    def update(self, input, target):
        return self._apply_update_plan(self._update_plan(input, target))


class BinaryBinnedPrecisionRecallCurve(_BinnedCounters):
    """Binned precision-recall curve for binary classification; compute
    returns ``(precision, recall, threshold)``.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import BinaryBinnedPrecisionRecallCurve
    >>> metric = BinaryBinnedPrecisionRecallCurve(threshold=[0.0, 0.5, 1.0], device="cpu")
    >>> _ = metric.update(torch.tensor([0.2, 0.8]), torch.tensor([0, 1]))
    >>> metric.compute()[0]
    tensor([0.5000, 1.0000, 1.0000, 1.0000])
    """

    def __init__(
        self, *, threshold: ThresholdLike = DEFAULT_NUM_THRESHOLD, device: DeviceLike = None
    ) -> None:
        super().__init__(device=device)
        threshold = create_threshold_tensor(threshold, device=self.device)
        self._add_counters(threshold, (threshold.shape[0],))

    def _update_plan(self, input, target):
        input, target = self._input(input), self._input(target)
        _binary_precision_recall_curve_update_input_check(input, target)
        return self._counter_plan(_binary_binned_update_jit, input, target)

    def compute(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        precision, recall = _binary_binned_compute_jit(self.num_tp, self.num_fp, self.num_fn)
        return precision, recall, self.threshold


class MulticlassBinnedPrecisionRecallCurve(_BinnedCounters):
    """Binned one-vs-rest precision-recall curves, one a class;
    ``optimization`` picks the update (``"vectorized"``: a (T, N, C)
    compare; ``"memory"``: a fused-index histogram). Compute returns
    ``(precisions, recalls, threshold)``, lists with one curve a class.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import MulticlassBinnedPrecisionRecallCurve
    >>> metric = MulticlassBinnedPrecisionRecallCurve(num_classes=3, threshold=3, device="cpu")
    >>> _ = metric.update(torch.tensor([[0.8, 0.1, 0.1], [0.2, 0.7, 0.1],
    ...     [0.1, 0.2, 0.7], [0.3, 0.5, 0.2]]), torch.tensor([0, 1, 2, 1]))
    >>> metric.compute()[0][1]
    tensor([0.5000, 1.0000, 1.0000, 1.0000])
    """

    def __init__(
        self,
        *,
        num_classes: int,
        threshold: ThresholdLike = DEFAULT_NUM_THRESHOLD,
        optimization: str = "vectorized",
        device: DeviceLike = None,
    ) -> None:
        super().__init__(device=device)
        threshold = create_threshold_tensor(threshold, device=self.device)
        _optimization_param_check(optimization)
        self.num_classes = num_classes
        self.optimization = optimization
        self._add_counters(threshold, (threshold.shape[0], num_classes))

    def _update_plan(self, input, target):
        input, target = self._input(input), self._input(target)
        _multiclass_precision_recall_curve_update_input_check(input, target, self.num_classes)
        return self._counter_plan(_MULTICLASS_KERNELS[self.optimization], input, target)

    def compute(self) -> Tuple[List[torch.Tensor], List[torch.Tensor], torch.Tensor]:
        return _multiclass_binned_precision_recall_curve_compute(
            self.num_tp, self.num_fp, self.num_fn, self.threshold
        )


class MultilabelBinnedPrecisionRecallCurve(_BinnedCounters):
    """Binned precision-recall curves, one a label; ``optimization`` as in
    ``MulticlassBinnedPrecisionRecallCurve``.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import MultilabelBinnedPrecisionRecallCurve
    >>> metric = MultilabelBinnedPrecisionRecallCurve(num_labels=3, threshold=3, device="cpu")
    >>> _ = metric.update(torch.tensor([[0.9, 0.2, 0.8], [0.1, 0.7, 0.3], [0.6, 0.5, 0.4]]),
    ...                   torch.tensor([[1, 0, 1], [0, 1, 0], [1, 0, 1]]))
    >>> metric.compute()[1][2]
    tensor([1.0000, 0.5000, 0.0000, 0.0000])
    """

    def __init__(
        self,
        *,
        num_labels: int,
        threshold: ThresholdLike = DEFAULT_NUM_THRESHOLD,
        optimization: str = "vectorized",
        device: DeviceLike = None,
    ) -> None:
        super().__init__(device=device)
        threshold = create_threshold_tensor(threshold, device=self.device)
        _optimization_param_check(optimization)
        self.num_labels = num_labels
        self.optimization = optimization
        self._add_counters(threshold, (threshold.shape[0], num_labels))

    def _update_plan(self, input, target):
        input, target = self._input(input), self._input(target)
        _multilabel_precision_recall_curve_update_input_check(input, target, self.num_labels)
        return self._counter_plan(_MULTILABEL_KERNELS[self.optimization], input, target)

    def compute(self) -> Tuple[List[torch.Tensor], List[torch.Tensor], torch.Tensor]:
        return _multiclass_binned_precision_recall_curve_compute(
            self.num_tp, self.num_fp, self.num_fn, self.threshold
        )
