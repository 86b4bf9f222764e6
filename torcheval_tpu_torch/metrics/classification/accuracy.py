"""Accuracy class metrics (counterpart of
``torcheval_tpu/metrics/classification/accuracy.py``: ``MulticlassAccuracy``,
``BinaryAccuracy``, ``MultilabelAccuracy`` and ``TopKMultilabelAccuracy``).
The classes own counter accumulation; the math lives in the functional
module. Every plan declares its mask-aware twin and the shared ``batch``
axis of its two inputs, for shape bucketing."""

from __future__ import annotations

from typing import Optional, TypeVar

import torch

from torcheval_tpu_torch.metrics.functional.classification.accuracy import (
    _accuracy_compute,
    _accuracy_param_check,
    _accuracy_update_input_check,
    _binary_accuracy_update,
    _binary_accuracy_update_input_check,
    _binary_accuracy_update_masked,
    _multiclass_accuracy_update,
    _multiclass_accuracy_update_masked,
    _multilabel_accuracy_param_check,
    _multilabel_accuracy_update,
    _multilabel_accuracy_update_input_check,
    _multilabel_accuracy_update_masked,
    _topk_multilabel_accuracy_param_check,
    _topk_multilabel_accuracy_update,
    _topk_multilabel_accuracy_update_input_check,
    _topk_multilabel_accuracy_update_masked,
)
from torcheval_tpu_torch.metrics.metric import MergeKind, Metric, UpdatePlan
from torcheval_tpu_torch.utils.convert import DeviceLike

TAccuracy = TypeVar("TAccuracy", bound="MulticlassAccuracy")

# input and target share one ragged leading axis
_BATCH2 = (("batch",), ("batch",))


class MulticlassAccuracy(Metric[torch.Tensor]):
    """Accuracy for multiclass classification; O(1) counter states.

    Args:
        average: ``"micro"`` | ``"macro"`` | ``"none"``/``None``.
        num_classes: required for non-micro averaging.
        k: top-k correctness (needs 2-D score inputs).
        device: where the state lives (CUDA by default).

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import MulticlassAccuracy
    >>> metric = MulticlassAccuracy(device="cpu")
    >>> _ = metric.update(torch.tensor([0, 2, 1, 3]), torch.tensor([0, 1, 2, 3]))
    >>> metric.compute()
    tensor(0.5000)
    """

    def __init__(
        self,
        *,
        average: Optional[str] = "micro",
        num_classes: Optional[int] = None,
        k: int = 1,
        device: DeviceLike = None,
    ) -> None:
        super().__init__(device=device)
        _accuracy_param_check(average, num_classes, k)
        self.average = average
        self.num_classes = num_classes
        self.k = k
        shape = () if average == "micro" else (num_classes,)
        self._add_state("num_correct", torch.zeros(shape), merge=MergeKind.SUM)
        self._add_state("num_total", torch.zeros(shape), merge=MergeKind.SUM)

    def _update_plan(self, input, target):
        input, target = self._input(input), self._input(target)
        _accuracy_update_input_check(input, target, self.num_classes, self.k)
        return UpdatePlan(
            _multiclass_accuracy_update,
            ("num_correct", "num_total"),
            (input, target),
            (self.average, self.num_classes, self.k),
            masked_kernel=_multiclass_accuracy_update_masked,
            batch_axes=_BATCH2,
        )

    def update(self: TAccuracy, input, target) -> TAccuracy:
        return self._apply_update_plan(self._update_plan(input, target))

    def compute(self) -> torch.Tensor:
        return _accuracy_compute(self.num_correct, self.num_total, self.average)


class BinaryAccuracy(MulticlassAccuracy):
    """Binary accuracy with score binarization at ``threshold``.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import BinaryAccuracy
    >>> metric = BinaryAccuracy(device="cpu")
    >>> _ = metric.update(torch.tensor([0.9, 0.2, 0.6, 0.1]), torch.tensor([1, 0, 0, 1]))
    >>> metric.compute()
    tensor(0.5000)
    """

    def __init__(self, *, threshold: float = 0.5, device: DeviceLike = None) -> None:
        super().__init__(device=device)
        self.threshold = threshold

    def _update_plan(self, input, target):
        input, target = self._input(input), self._input(target)
        _binary_accuracy_update_input_check(input, target)
        return UpdatePlan(
            _binary_accuracy_update,
            ("num_correct", "num_total"),
            (input, target),
            (float(self.threshold),),
            masked_kernel=_binary_accuracy_update_masked,
            batch_axes=_BATCH2,
        )


class MultilabelAccuracy(MulticlassAccuracy):
    """Multilabel accuracy under one of five criteria (``exact_match``,
    ``hamming``, ``overlap``, ``contain``, ``belong``; see
    ``functional.multilabel_accuracy``).

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import MultilabelAccuracy
    >>> metric = MultilabelAccuracy(device="cpu")
    >>> _ = metric.update(torch.tensor([[0.1, 0.9], [0.8, 0.9]]), torch.tensor([[0, 1], [1, 1]]))
    >>> metric.compute()
    tensor(1.)
    """

    def __init__(
        self,
        *,
        threshold: float = 0.5,
        criteria: str = "exact_match",
        device: DeviceLike = None,
    ) -> None:
        super().__init__(device=device)
        _multilabel_accuracy_param_check(criteria)
        self.threshold = threshold
        self.criteria = criteria

    def _update_plan(self, input, target):
        input, target = self._input(input), self._input(target)
        _multilabel_accuracy_update_input_check(input, target)
        return UpdatePlan(
            _multilabel_accuracy_update,
            ("num_correct", "num_total"),
            (input, target),
            (float(self.threshold), self.criteria),
            masked_kernel=_multilabel_accuracy_update_masked,
            batch_axes=_BATCH2,
        )


class TopKMultilabelAccuracy(MulticlassAccuracy):
    """Multilabel accuracy with the ``k`` top-scored labels of each row
    predicted positive (ties to the lower label index).

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import TopKMultilabelAccuracy
    >>> metric = TopKMultilabelAccuracy(criteria="hamming", k=2, device="cpu")
    >>> _ = metric.update(torch.tensor([[0.9, 0.2, 0.8], [0.1, 0.7, 0.3], [0.6, 0.5, 0.4]]),
    ...                   torch.tensor([[1, 0, 1], [0, 1, 0], [1, 0, 1]]))
    >>> metric.compute()
    tensor(0.6667)
    """

    def __init__(
        self,
        *,
        criteria: str = "exact_match",
        k: int = 2,
        device: DeviceLike = None,
    ) -> None:
        super().__init__(device=device)
        _topk_multilabel_accuracy_param_check(criteria, k)
        self.criteria = criteria
        self.k = k

    def _update_plan(self, input, target):
        input, target = self._input(input), self._input(target)
        _topk_multilabel_accuracy_update_input_check(input, target, self.k)
        return UpdatePlan(
            _topk_multilabel_accuracy_update,
            ("num_correct", "num_total"),
            (input, target),
            (self.criteria, self.k),
            masked_kernel=_topk_multilabel_accuracy_update_masked,
            batch_axes=_BATCH2,
        )
