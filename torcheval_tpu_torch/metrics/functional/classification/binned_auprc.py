"""Binned AUPRC: the Riemann AUPRC over a fixed threshold grid.

Counterpart of ``torcheval_tpu/metrics/functional/classification/
binned_auprc.py``: the binned precision-recall counters
(``binned_precision_recall_curve.py``) integrated per task, class or label
by ``_binned_auprc_from_counts`` (:35). Grids must start at 0 and end at
1. The functional forms return ``(auprc, threshold)``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from torcheval_tpu_torch.metrics.functional.classification.auprc import (
    _binary_auprc_update_input_check,
    _multiclass_auprc_update_input_check,
    _multilabel_auprc_update_input_check,
)
from torcheval_tpu_torch.metrics.functional.classification.binned_precision_recall_curve import (
    ThresholdLike,
    _binary_binned_compute_jit,
    _binary_binned_update_jit,
    _multiclass_binned_precision_recall_curve_update,
    _multilabel_binned_precision_recall_curve_update,
)
from torcheval_tpu_torch.metrics.functional.tensor_utils import create_threshold_tensor
from torcheval_tpu_torch.utils.convert import (
    DeviceLike,
    functional_device,
    narrow_64,
    to_torch,
)

DEFAULT_NUM_THRESHOLD = 100


def _binned_auprc_from_counts(
    num_tp: torch.Tensor, num_fp: torch.Tensor, num_fn: torch.Tensor
) -> torch.Tensor:
    """(..., T) counters -> Riemann AUPRC over the leading axes; the
    curve already ends at (precision 1, recall 0)."""
    precision, recall = _binary_binned_compute_jit(num_tp, num_fp, num_fn)
    integral = -torch.sum((recall[..., 1:] - recall[..., :-1]) * precision[..., :-1], dim=-1)
    return torch.nan_to_num(integral, nan=0.0)


def _binary_binned_auprc_param_check(num_tasks: int, threshold: torch.Tensor) -> None:
    if num_tasks < 1:
        raise ValueError(
            "`num_tasks` value should be greater than and equal to 1, but "
            f"received {num_tasks}. "
        )


def _binary_binned_auprc_compute(
    input: torch.Tensor, target: torch.Tensor, num_tasks: int, threshold: torch.Tensor
) -> torch.Tensor:
    # one row, or each row of (tasks, n): the update takes either
    return _binned_auprc_from_counts(*_binary_binned_update_jit(narrow_64(input), target, threshold))


def binary_binned_auprc(
    input,
    target,
    *,
    num_tasks: int = 1,
    threshold: ThresholdLike = DEFAULT_NUM_THRESHOLD,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Binned AUPRC for binary classification: ``(auprc, threshold)``
    (class version: ``BinaryBinnedAUPRC``).

    >>> import torch
    >>> from torcheval_tpu_torch.metrics.functional import binary_binned_auprc
    >>> binary_binned_auprc(torch.tensor([0.1, 0.5, 0.7, 0.8]), torch.tensor([1, 0, 1, 1]),
    ...                     threshold=5)
    (tensor(0.8056), tensor([0.0000, 0.2500, 0.5000, 0.7500, 1.0000]))
    """
    dev = functional_device(device, input, target)
    input, target = to_torch(input, device=dev), to_torch(target, device=dev)
    threshold = create_threshold_tensor(threshold, span=True, device=dev)
    _binary_binned_auprc_param_check(num_tasks, threshold)
    _binary_auprc_update_input_check(input, target, num_tasks)
    return _binary_binned_auprc_compute(input, target, num_tasks, threshold), threshold


def _average_param_check(count: int, what: str, average: Optional[str]) -> None:
    average_options = ("macro", "none", None)
    if average not in average_options:
        raise ValueError(
            f"`average` was not in the allowed value of {average_options}, "
            f"got {average}."
        )
    if count < 2:
        raise ValueError(f"`{what}` has to be at least 2.")


def _multiclass_binned_auprc_param_check(
    num_classes: int, threshold: torch.Tensor, average: Optional[str]
) -> None:
    _average_param_check(num_classes, "num_classes", average)


def _multilabel_binned_auprc_param_check(
    num_labels: int, threshold: torch.Tensor, average: Optional[str]
) -> None:
    _average_param_check(num_labels, "num_labels", average)


def _macro(values: torch.Tensor, average: Optional[str]) -> torch.Tensor:
    return torch.mean(values) if average == "macro" else values


def multiclass_binned_auprc(
    input,
    target,
    *,
    num_classes: Optional[int] = None,
    threshold: ThresholdLike = DEFAULT_NUM_THRESHOLD,
    average: Optional[str] = "macro",
    optimization: str = "vectorized",
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Binned one-vs-rest AUPRC for multiclass classification:
    ``(auprc, threshold)`` (class version: ``MulticlassBinnedAUPRC``).

    >>> import torch
    >>> from torcheval_tpu_torch.metrics.functional import multiclass_binned_auprc
    >>> multiclass_binned_auprc(torch.tensor([[0.8, 0.1, 0.1], [0.2, 0.7, 0.1],
    ...     [0.1, 0.2, 0.7], [0.3, 0.5, 0.2]]), torch.tensor([0, 1, 2, 1]),
    ...     num_classes=3, threshold=5)
    (tensor(1.), tensor([0.0000, 0.2500, 0.5000, 0.7500, 1.0000]))
    """
    dev = functional_device(device, input, target)
    input, target = to_torch(input, device=dev), to_torch(target, device=dev)
    threshold = create_threshold_tensor(threshold, span=True, device=dev)
    if num_classes is None and input.ndim == 2:
        num_classes = input.shape[1]
    _multiclass_binned_auprc_param_check(num_classes, threshold, average)
    _multiclass_auprc_update_input_check(input, target, num_classes)
    num_tp, num_fp, num_fn = _multiclass_binned_precision_recall_curve_update(
        input, target, num_classes, threshold, optimization
    )
    return _macro(_binned_auprc_from_counts(num_tp.T, num_fp.T, num_fn.T), average), threshold


def multilabel_binned_auprc(
    input,
    target,
    *,
    num_labels: Optional[int] = None,
    threshold: ThresholdLike = DEFAULT_NUM_THRESHOLD,
    average: Optional[str] = "macro",
    optimization: str = "vectorized",
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Binned AUPRC per label for multilabel classification:
    ``(auprc, threshold)`` (class version: ``MultilabelBinnedAUPRC``).

    >>> import torch
    >>> from torcheval_tpu_torch.metrics.functional import multilabel_binned_auprc
    >>> multilabel_binned_auprc(torch.tensor([[0.9, 0.2, 0.8], [0.1, 0.7, 0.3],
    ...     [0.6, 0.5, 0.4]]), torch.tensor([[1, 0, 1], [0, 1, 0], [1, 0, 1]]),
    ...     num_labels=3, threshold=5)
    (tensor(0.7778), tensor([0.0000, 0.2500, 0.5000, 0.7500, 1.0000]))
    """
    dev = functional_device(device, input, target)
    input, target = to_torch(input, device=dev), to_torch(target, device=dev)
    threshold = create_threshold_tensor(threshold, span=True, device=dev)
    if num_labels is None and input.ndim == 2:
        num_labels = input.shape[1]
    _multilabel_binned_auprc_param_check(num_labels, threshold, average)
    _multilabel_auprc_update_input_check(input, target, num_labels)
    num_tp, num_fp, num_fn = _multilabel_binned_precision_recall_curve_update(
        input, target, num_labels, threshold, optimization
    )
    return _macro(_binned_auprc_from_counts(num_tp.T, num_fp.T, num_fn.T), average), threshold
