"""Confusion matrix class metrics (counterpart of
``torcheval_tpu/metrics/classification/confusion_matrix.py``): one
``(C, C)`` int32 counter state with ``SUM`` merge, so merged and synced
matrices are exact."""

from __future__ import annotations

from typing import Optional, TypeVar

import torch

from torcheval_tpu_torch.metrics.functional.classification.confusion_matrix import (
    _binary_confusion_matrix_update_input_check,
    _binary_confusion_matrix_update_jit,
    _confusion_matrix_compute,
    _confusion_matrix_param_check,
    _confusion_matrix_update_input_check,
    _confusion_matrix_update_jit,
)
from torcheval_tpu_torch.metrics.metric import MergeKind, Metric, UpdatePlan
from torcheval_tpu_torch.utils.convert import DeviceLike

TMulticlassConfusionMatrix = TypeVar(
    "TMulticlassConfusionMatrix", bound="MulticlassConfusionMatrix"
)


def _no_shard(shard, name: str) -> None:
    """Sharded state is not ported yet (ROADMAP Queue A, item A6)."""
    if shard is not None:
        raise NotImplementedError(
            f"{name}(shard=...) needs sharded metric state, which "
            "torcheval_tpu_torch does not have yet (ROADMAP Queue A, item A6); "
            "pass shard=None."
        )


class MulticlassConfusionMatrix(Metric[torch.Tensor]):
    """Multiclass confusion matrix; entry (i, j) counts true class i
    predicted as class j.

    Args:
        num_classes: C, at least 2.
        normalize: ``None``/``"none"``, ``"pred"``, ``"true"`` or ``"all"``.
        device: where the state lives (CUDA by default).
        shard: only ``None`` (sharded state is not ported yet).

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import MulticlassConfusionMatrix
    >>> metric = MulticlassConfusionMatrix(3, device="cpu")
    >>> _ = metric.update(torch.tensor([0, 2, 1, 1]), torch.tensor([0, 1, 2, 1]))
    >>> metric.compute()
    tensor([[1, 0, 0],
            [0, 1, 1],
            [0, 1, 0]], dtype=torch.int32)
    """

    def __init__(
        self,
        num_classes: int,
        *,
        normalize: Optional[str] = None,
        device: DeviceLike = None,
        shard=None,
    ) -> None:
        _no_shard(shard, type(self).__name__)
        super().__init__(device=device)
        _confusion_matrix_param_check(num_classes, normalize)
        self.num_classes = num_classes
        self.normalize = normalize
        self._add_state(
            "confusion_matrix",
            torch.zeros((num_classes, num_classes), dtype=torch.int32),
            merge=MergeKind.SUM,
        )

    def _update_plan(self, input, target):
        input, target = self._input(input), self._input(target)
        _confusion_matrix_update_input_check(input, target, self.num_classes)
        return UpdatePlan(
            _confusion_matrix_update_jit,
            ("confusion_matrix",),
            (input, target),
            (self.num_classes,),
        )

    def update(self: TMulticlassConfusionMatrix, input, target) -> TMulticlassConfusionMatrix:
        return self._apply_update_plan(self._update_plan(input, target))

    def compute(self) -> torch.Tensor:
        return _confusion_matrix_compute(self.confusion_matrix, self.normalize)

    def normalized(self, normalize: Optional[str] = None) -> torch.Tensor:
        """The matrix under another normalization."""
        _confusion_matrix_param_check(self.num_classes, normalize)
        return _confusion_matrix_compute(self.confusion_matrix, normalize)


class BinaryConfusionMatrix(MulticlassConfusionMatrix):
    """2x2 confusion matrix of scores binarized at ``threshold``.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import BinaryConfusionMatrix
    >>> metric = BinaryConfusionMatrix(device="cpu")
    >>> _ = metric.update(torch.tensor([0.2, 0.8, 0.6, 0.3]), torch.tensor([0, 1, 1, 0]))
    >>> metric.compute()
    tensor([[2, 0],
            [0, 2]], dtype=torch.int32)
    """

    def __init__(
        self,
        *,
        threshold: float = 0.5,
        normalize: Optional[str] = None,
        device: DeviceLike = None,
    ) -> None:
        super().__init__(num_classes=2, normalize=normalize, device=device)
        self.threshold = threshold

    def _update_plan(self, input, target):
        input, target = self._input(input), self._input(target)
        _binary_confusion_matrix_update_input_check(input, target)
        return UpdatePlan(
            _binary_confusion_matrix_update_jit,
            ("confusion_matrix",),
            (input, target),
            (float(self.threshold),),
        )
