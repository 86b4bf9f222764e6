"""Confusion matrices (binary and multiclass).

Counterpart of ``torcheval_tpu/metrics/functional/classification/
confusion_matrix.py``: the ``(C, C)`` int32 matrix is one ``segment_count``
of the fused cell index ``target * C + prediction``
(``_confusion_matrix_flat_index`` :37), in int32 as the JAX package
computes it, so a fused index outside ``[0, C * C)`` is dropped; ``normalize``
is ``None``/``"none"``, ``"pred"``, ``"true"`` or ``"all"``.
"""

from __future__ import annotations

from typing import Optional

import torch

from torcheval_tpu_torch.config import debug_validation_enabled
from torcheval_tpu_torch.metrics.functional.tensor_utils import argmax_last, valid_mask
from torcheval_tpu_torch.ops.segment import segment_count
from torcheval_tpu_torch.utils.convert import DeviceLike, functional_device, to_torch


def _confusion_matrix_flat_index(
    input: torch.Tensor, target: torch.Tensor, num_classes: int
) -> torch.Tensor:
    """Flat ``target * C + prediction`` cell per sample (int32; scores
    become predictions by ``argmax_last``)."""
    if input.ndim == 2:
        input = argmax_last(input)
    return target.to(torch.int32) * num_classes + input.to(torch.int32)


def _confusion_matrix_update_jit(
    input: torch.Tensor, target: torch.Tensor, num_classes: int
) -> torch.Tensor:
    flat = _confusion_matrix_flat_index(input, target, num_classes)
    return segment_count(flat, num_classes * num_classes).reshape(num_classes, num_classes)


def _binary_confusion_matrix_update_jit(
    input: torch.Tensor, target: torch.Tensor, threshold: float
) -> torch.Tensor:
    pred = torch.where(input < threshold, 0, 1)
    return _confusion_matrix_update_jit(pred, target, 2)


def _confusion_matrix_update_masked(
    input: torch.Tensor, target: torch.Tensor, valid_sizes: torch.Tensor, num_classes: int
) -> torch.Tensor:
    """Mask-aware twin of ``_confusion_matrix_update_jit`` (shape
    bucketing): padded rows count in no cell."""
    valid = valid_mask(target.shape[0], valid_sizes[0])
    flat = _confusion_matrix_flat_index(input, target, num_classes)
    counts = segment_count(flat, num_classes * num_classes, mask=valid)
    return counts.reshape(num_classes, num_classes)


def _binary_confusion_matrix_update_masked(
    input: torch.Tensor, target: torch.Tensor, valid_sizes: torch.Tensor, threshold: float
) -> torch.Tensor:
    return _confusion_matrix_update_masked(
        torch.where(input < threshold, 0, 1), target, valid_sizes, 2
    )


def _l1_normalize(cm: torch.Tensor, dim: int) -> torch.Tensor:
    cm = cm.to(torch.float32)
    denom = torch.sum(torch.abs(cm), dim=dim, keepdim=True)
    return cm / torch.clamp(denom, min=1e-12)


def _confusion_matrix_compute(
    confusion_matrix: torch.Tensor, normalize: Optional[str]
) -> torch.Tensor:
    if normalize == "pred":
        return _l1_normalize(confusion_matrix, dim=0)
    if normalize == "true":
        return _l1_normalize(confusion_matrix, dim=1)
    if normalize == "all":
        cm = confusion_matrix.to(torch.float32)
        return cm / torch.sum(cm)
    return confusion_matrix


def _confusion_matrix_param_check(num_classes: int, normalize: Optional[str]) -> None:
    if num_classes < 2:
        raise ValueError("Must be at least two classes for confusion matrix")
    if normalize is not None and normalize not in ("all", "pred", "true", "none"):
        raise ValueError("normalize must be one of 'all', 'pred', 'true', or 'none'.")


def _confusion_matrix_update_input_check(
    input: torch.Tensor, target: torch.Tensor, num_classes: int
) -> None:
    if input.shape[0] != target.shape[0]:
        raise ValueError(
            "The `input` and `target` should have the same first dimension, "
            f"got shapes {tuple(input.shape)} and {tuple(target.shape)}."
        )
    if target.ndim != 1:
        raise ValueError(
            f"target should be a one-dimensional tensor, got shape {tuple(target.shape)}."
        )
    if not input.ndim == 1 and not (input.ndim == 2 and input.shape[1] == num_classes):
        raise ValueError(
            "input should have shape of (num_sample,) or "
            f"(num_sample, num_classes), got {tuple(input.shape)}."
        )
    if debug_validation_enabled():
        # a host readback: the reference checks max() on every update
        hi = int(torch.max(target))
        if hi >= num_classes:
            raise ValueError(
                f"target values must be in [0, {num_classes}), got max {hi}."
            )


def _binary_confusion_matrix_update_input_check(
    input: torch.Tensor, target: torch.Tensor
) -> None:
    if input.ndim != 1:
        raise ValueError(
            "input should be a one-dimensional tensor for binary confusion "
            f"matrix, got shape {tuple(input.shape)}."
        )
    if target.ndim != 1:
        raise ValueError(
            "target should be a one-dimensional tensor for binary confusion "
            f"matrix, got shape {tuple(target.shape)}."
        )
    if input.shape != target.shape:
        raise ValueError(
            "The `input` and `target` should have the same dimensions, "
            f"got shapes {tuple(input.shape)} and {tuple(target.shape)}."
        )


def multiclass_confusion_matrix(
    input,
    target,
    *,
    num_classes: int,
    normalize: Optional[str] = None,
    device: DeviceLike = None,
) -> torch.Tensor:
    """The ``(num_classes, num_classes)`` confusion matrix: entry (i, j)
    counts examples of true class i predicted as class j (class version:
    ``MulticlassConfusionMatrix``).

    >>> import torch
    >>> from torcheval_tpu_torch.metrics.functional import multiclass_confusion_matrix
    >>> multiclass_confusion_matrix(torch.tensor([0, 2, 1, 1]), torch.tensor([0, 1, 2, 1]),
    ...                             num_classes=3)
    tensor([[1, 0, 0],
            [0, 1, 1],
            [0, 1, 0]], dtype=torch.int32)
    """
    dev = functional_device(device, input, target)
    input, target = to_torch(input, device=dev), to_torch(target, device=dev)
    _confusion_matrix_param_check(num_classes, normalize)
    _confusion_matrix_update_input_check(input, target, num_classes)
    cm = _confusion_matrix_update_jit(input, target, num_classes)
    return _confusion_matrix_compute(cm, normalize)


def binary_confusion_matrix(
    input,
    target,
    *,
    threshold: float = 0.5,
    normalize: Optional[str] = None,
    device: DeviceLike = None,
) -> torch.Tensor:
    """The 2x2 confusion matrix of scores binarized at ``threshold``
    (class version: ``BinaryConfusionMatrix``).

    >>> import torch
    >>> from torcheval_tpu_torch.metrics.functional import binary_confusion_matrix
    >>> binary_confusion_matrix(torch.tensor([0.2, 0.8, 0.6, 0.3]), torch.tensor([0, 1, 1, 0]))
    tensor([[2, 0],
            [0, 2]], dtype=torch.int32)
    """
    dev = functional_device(device, input, target)
    input, target = to_torch(input, device=dev), to_torch(target, device=dev)
    _confusion_matrix_param_check(2, normalize)
    _binary_confusion_matrix_update_input_check(input, target)
    cm = _binary_confusion_matrix_update_jit(input, target, float(threshold))
    return _confusion_matrix_compute(cm, normalize)
