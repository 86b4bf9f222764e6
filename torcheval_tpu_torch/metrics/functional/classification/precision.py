"""Precision (binary and multiclass).

Counterpart of ``torcheval_tpu/metrics/functional/classification/
precision.py``: micro counts, or per-class counts through ``segment_sum``
(targets and predictions outside ``[0, num_classes)`` dropped), averaged
``micro``, ``macro`` (over classes seen in the labels or the
predictions), ``weighted`` (by label count) or not at all; a class with no
prediction has precision 0.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import torch

from torcheval_tpu_torch.config import debug_validation_enabled
from torcheval_tpu_torch.metrics.functional.tensor_utils import (
    argmax_last,
    nan_safe_divide,
    segment_sum,
    valid_mask,
)
from torcheval_tpu_torch.utils.convert import DeviceLike, functional_device, to_torch

_logger: logging.Logger = logging.getLogger(__name__)


def _precision_update_jit(
    input: torch.Tensor,
    target: torch.Tensor,
    num_classes: Optional[int],
    average: Optional[str],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if input.ndim == 2:
        input = argmax_last(input)
    if average == "micro":
        num_tp = torch.sum(input == target).to(torch.float32)
        num_fp = torch.sum(input != target).to(torch.float32)
        return num_tp, num_fp, torch.zeros((), device=target.device)
    ones = torch.ones(target.shape, dtype=torch.float32, device=target.device)
    num_label = segment_sum(ones, target, num_classes)
    tp_mask = (input == target).to(torch.float32)
    num_tp = segment_sum(tp_mask, target, num_classes)
    num_fp = segment_sum(1.0 - tp_mask, input.to(target.dtype), num_classes)
    return num_tp, num_fp, num_label


def _precision_update_masked(
    input: torch.Tensor,
    target: torch.Tensor,
    valid_sizes: torch.Tensor,
    num_classes: Optional[int],
    average: Optional[str],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mask-aware twin of ``_precision_update_jit`` (shape bucketing)."""
    valid = valid_mask(target.shape[0], valid_sizes[0])
    if input.ndim == 2:
        input = argmax_last(input)
    if average == "micro":
        num_tp = torch.sum((input == target).to(torch.float32) * valid)
        num_fp = torch.sum((input != target).to(torch.float32) * valid)
        return num_tp, num_fp, torch.zeros((), device=target.device)
    num_label = segment_sum(valid, target, num_classes)
    tp_mask = (input == target).to(torch.float32) * valid
    num_tp = segment_sum(tp_mask, target, num_classes)
    num_fp = segment_sum(valid - tp_mask, input.to(target.dtype), num_classes)
    return num_tp, num_fp, num_label


def _precision_compute(
    num_tp: torch.Tensor,
    num_fp: torch.Tensor,
    num_label: torch.Tensor,
    average: Optional[str],
) -> torch.Tensor:
    denom = num_tp + num_fp
    if average in (None, "None"):
        if debug_validation_enabled() and bool(torch.any((denom == 0) & (num_label == 0))):
            _logger.warning(
                "One or more classes have zero instances in both the "
                "predictions and the ground truth labels. Precision is "
                "still logged as zero."
            )
    precision = torch.nan_to_num(nan_safe_divide(num_tp, denom))
    if average == "micro":
        return precision
    if average == "macro":
        mask = (num_label != 0) | (denom != 0)
        return torch.sum(torch.where(mask, precision, torch.zeros_like(precision))) / torch.clamp(
            torch.sum(mask), min=1
        )
    if average == "weighted":
        return torch.sum(precision * (num_label / torch.sum(num_label)))
    return precision


def _precision_param_check(num_classes: Optional[int], average: Optional[str]) -> None:
    average_options = ("micro", "macro", "weighted", None)
    if average not in average_options:
        raise ValueError(
            f"`average` was not in the allowed value of {average_options}, "
            f"got {average}."
        )
    if average != "micro" and (num_classes is None or num_classes <= 0):
        raise ValueError(
            f"num_classes should be a positive number when average={average}, "
            f"got num_classes={num_classes}."
        )


def _precision_update_input_check(
    input: torch.Tensor, target: torch.Tensor, num_classes: Optional[int]
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
    if not input.ndim == 1 and not (
        input.ndim == 2 and (num_classes is None or input.shape[1] == num_classes)
    ):
        raise ValueError(
            "input should have shape of (num_sample,) or "
            f"(num_sample, num_classes), got {tuple(input.shape)}."
        )


def multiclass_precision(
    input,
    target,
    *,
    num_classes: Optional[int] = None,
    average: Optional[str] = "micro",
    device: DeviceLike = None,
) -> torch.Tensor:
    """Precision for multiclass classification (class version:
    ``MulticlassPrecision``).

    >>> import torch
    >>> from torcheval_tpu_torch.metrics.functional import multiclass_precision
    >>> multiclass_precision(torch.tensor([0, 2, 1, 3]), torch.tensor([0, 1, 2, 3]))
    tensor(0.5000)
    """
    dev = functional_device(device, input, target)
    input, target = to_torch(input, device=dev), to_torch(target, device=dev)
    _precision_param_check(num_classes, average)
    _precision_update_input_check(input, target, num_classes)
    num_tp, num_fp, num_label = _precision_update_jit(input, target, num_classes, average)
    return _precision_compute(num_tp, num_fp, num_label, average)


def _binary_precision_update_jit(
    input: torch.Tensor, target: torch.Tensor, threshold: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    pred = torch.where(input < threshold, 0, 1)
    num_tp = torch.sum(pred * target, dim=-1).to(torch.float32)
    num_fp = torch.sum(pred, dim=-1).to(torch.float32) - num_tp
    return num_tp, num_fp, torch.zeros((), device=input.device)


def _binary_precision_update_masked(
    input: torch.Tensor, target: torch.Tensor, valid_sizes: torch.Tensor, threshold: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    valid = valid_mask(target.shape[0], valid_sizes[0])
    pred = torch.where(input < threshold, 0, 1) * valid
    num_tp = torch.sum(pred * target, dim=-1).to(torch.float32)
    num_fp = torch.sum(pred, dim=-1).to(torch.float32) - num_tp
    return num_tp, num_fp, torch.zeros((), device=input.device)


def _binary_precision_update_input_check(input: torch.Tensor, target: torch.Tensor) -> None:
    if input.shape != target.shape:
        raise ValueError(
            "The `input` and `target` should have the same dimensions, "
            f"got shapes {tuple(input.shape)} and {tuple(target.shape)}."
        )


def binary_precision(
    input, target, *, threshold: float = 0.5, device: DeviceLike = None
) -> torch.Tensor:
    """Precision of scores binarized at ``threshold`` (class version:
    ``BinaryPrecision``).

    >>> import torch
    >>> from torcheval_tpu_torch.metrics.functional import binary_precision
    >>> binary_precision(torch.tensor([0.2, 0.8, 0.6, 0.3]), torch.tensor([0, 1, 1, 0]))
    tensor(1.)
    """
    dev = functional_device(device, input, target)
    input, target = to_torch(input, device=dev), to_torch(target, device=dev)
    _binary_precision_update_input_check(input, target)
    num_tp, num_fp, num_label = _binary_precision_update_jit(input, target, float(threshold))
    return _precision_compute(num_tp, num_fp, num_label, "micro")
