"""Precision-recall curves (binary, multiclass, multilabel).

Counterpart of ``torcheval_tpu/metrics/functional/classification/
precision_recall_curve.py`` (:29-257). The curve arrays are computed at the
full sample count (``_curve_kernels.prc_arrays``, batched over classes or
labels); the tie compaction, whose output length is the number of distinct
thresholds, runs last, in ``_compact``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from torcheval_tpu_torch.metrics.functional.classification._curve_kernels import (
    _curve_inputs,
    prc_arrays,
)
from torcheval_tpu_torch.utils.convert import DeviceLike

Curve = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
Curves = Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]


def _compact(
    precision: torch.Tensor,
    recall: torch.Tensor,
    threshold: torch.Tensor,
    is_end: torch.Tensor,
) -> Curve:
    """Keep one point per tie run and append the terminal (precision 1,
    recall 0) point, which has no threshold."""
    p = precision[is_end]
    r = recall[is_end]
    t = threshold[is_end]
    p = torch.cat([p, torch.ones(1, dtype=p.dtype, device=p.device)])
    r = torch.cat([r, torch.zeros(1, dtype=r.dtype, device=r.device)])
    return p, r, t


def _trim(arrays, valid_count: Optional[int]):
    """Drop the padding of a buffered metric's full-capacity arrays: in
    ascending-threshold order the padded slots come first."""
    if valid_count is None:
        return arrays
    pad = arrays[0].shape[-1] - valid_count
    return tuple(a[..., pad:] for a in arrays)


def _binary_precision_recall_curve_compute(
    input: torch.Tensor,
    target: torch.Tensor,
    valid_count: Optional[int] = None,
) -> Curve:
    """``valid_count``: the arrays come from a padded buffer
    (``metrics/_buffer.py``) holding that many samples."""
    return _compact(*_trim(prc_arrays(input, target), valid_count))


def _binary_precision_recall_curve_update_input_check(
    input: torch.Tensor, target: torch.Tensor
) -> None:
    if input.shape != target.shape:
        raise ValueError(
            "The `input` and `target` should have the same shape, "
            f"got shapes {tuple(input.shape)} and {tuple(target.shape)}."
        )
    if input.ndim != 1:
        raise ValueError(
            "input should be a one-dimensional tensor, got shape "
            f"{tuple(input.shape)}."
        )


def binary_precision_recall_curve(input, target, *, device: DeviceLike = None) -> Curve:
    """``(precision, recall, thresholds)`` for binary classification
    (class version: ``BinaryPrecisionRecallCurve``), thresholds ascending;
    the final (precision 1, recall 0) point has no threshold.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics.functional import binary_precision_recall_curve
    >>> p, r, t = binary_precision_recall_curve(
    ...     torch.tensor([0.1, 0.5, 0.7, 0.8]), torch.tensor([0, 0, 1, 1]))
    """
    input, target = _curve_inputs(device, input, target)
    _binary_precision_recall_curve_update_input_check(input, target)
    return _binary_precision_recall_curve_compute(input, target)


def _per_row(arrays, valid_count: Optional[int]) -> Curves:
    """Compact each row (class or label) of batched curve arrays."""
    p_full, r_full, t_full, end_full = _trim(arrays, valid_count)
    precisions, recalls, thresholds = [], [], []
    for row in range(p_full.shape[0]):
        p, r, t = _compact(p_full[row], r_full[row], t_full[row], end_full[row])
        precisions.append(p)
        recalls.append(r)
        thresholds.append(t)
    return precisions, recalls, thresholds


def _multiclass_precision_recall_curve_update_input_check(
    input: torch.Tensor, target: torch.Tensor, num_classes: Optional[int]
) -> None:
    if input.shape[0] != target.shape[0]:
        raise ValueError(
            "The `input` and `target` should have the same first dimension, "
            f"got shapes {tuple(input.shape)} and {tuple(target.shape)}."
        )
    if target.ndim != 1:
        raise ValueError(
            "target should be a one-dimensional tensor, got shape "
            f"{tuple(target.shape)}."
        )
    if not (
        input.ndim == 2 and (num_classes is None or input.shape[1] == num_classes)
    ):
        raise ValueError(
            "input should have shape of (num_sample, num_classes), "
            f"got {tuple(input.shape)} and num_classes={num_classes}."
        )


def _multiclass_precision_recall_curve_compute(
    input: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    valid_count: Optional[int] = None,
) -> Curves:
    classes = torch.arange(num_classes, device=input.device)
    targets = (target[None, :] == classes[:, None]).to(torch.int32)
    return _per_row(prc_arrays(input.T, targets), valid_count)


def multiclass_precision_recall_curve(
    input, target, *, num_classes: Optional[int] = None, device: DeviceLike = None
) -> Curves:
    """Per-class precision-recall curves for multiclass classification
    (class version: ``MulticlassPrecisionRecallCurve``): lists of
    precision, recall and thresholds, one entry per class.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics.functional import multiclass_precision_recall_curve
    >>> p, r, t = multiclass_precision_recall_curve(torch.tensor([[0.8, 0.1, 0.1], [0.2, 0.7, 0.1],
    ...     [0.1, 0.2, 0.7], [0.3, 0.5, 0.2]]), torch.tensor([0, 1, 2, 1]), num_classes=3)
    >>> t[0]
    tensor([0.1000, 0.2000, 0.3000, 0.8000])
    """
    input, target = _curve_inputs(device, input, target)
    if num_classes is None and input.ndim == 2:
        num_classes = input.shape[1]
    _multiclass_precision_recall_curve_update_input_check(input, target, num_classes)
    return _multiclass_precision_recall_curve_compute(input, target, num_classes)


def _multilabel_precision_recall_curve_update_input_check(
    input: torch.Tensor, target: torch.Tensor, num_labels: Optional[int]
) -> None:
    if input.shape != target.shape:
        raise ValueError(
            "Expected both input.shape and target.shape to have the same shape"
            f" but got {tuple(input.shape)} and {tuple(target.shape)}."
        )
    if input.ndim != 2:
        raise ValueError(
            "input should be a two-dimensional tensor, got shape "
            f"{tuple(input.shape)}."
        )
    if num_labels is not None and input.shape[1] != num_labels:
        raise ValueError(
            f"input should have shape of (num_sample, num_labels), "
            f"got {tuple(input.shape)} and num_labels={num_labels}."
        )


def _multilabel_precision_recall_curve_compute(
    input: torch.Tensor,
    target: torch.Tensor,
    valid_count: Optional[int] = None,
) -> Curves:
    return _per_row(prc_arrays(input.T, target.T), valid_count)


def multilabel_precision_recall_curve(
    input, target, *, num_labels: Optional[int] = None, device: DeviceLike = None
) -> Curves:
    """Per-label precision-recall curves for multilabel classification
    (class version: ``MultilabelPrecisionRecallCurve``).

    >>> import torch
    >>> from torcheval_tpu_torch.metrics.functional import multilabel_precision_recall_curve
    >>> p, r, t = multilabel_precision_recall_curve(torch.tensor([[0.9, 0.2, 0.8], [0.1, 0.7, 0.3],
    ...     [0.6, 0.5, 0.4]]), torch.tensor([[1, 0, 1], [0, 1, 0], [1, 0, 1]]), num_labels=3)
    >>> r[0]
    tensor([1.0000, 1.0000, 0.5000, 0.0000])
    """
    input, target = _curve_inputs(device, input, target)
    if num_labels is None and input.ndim == 2:
        num_labels = input.shape[1]
    _multilabel_precision_recall_curve_update_input_check(input, target, num_labels)
    return _multilabel_precision_recall_curve_compute(input, target)
