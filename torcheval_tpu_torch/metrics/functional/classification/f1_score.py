"""F1 score (multiclass and binary).

Counterpart of ``torcheval_tpu/metrics/functional/classification/f1_score.py``
(``_f1_score_update_jit`` :33, ``_f1_score_compute_jit`` :81, the checks,
``multiclass_f1_score``, ``binary_f1_score``). Per-class counts use
``segment_sum``, so targets and predictions outside ``[0, num_classes)``
are dropped as the JAX package drops them.
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
)
from torcheval_tpu_torch.utils.convert import DeviceLike, functional_device, to_torch

_logger: logging.Logger = logging.getLogger(__name__)


def _f1_score_update_jit(
    input: torch.Tensor,
    target: torch.Tensor,
    num_classes: Optional[int],
    average: Optional[str],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if input.ndim == 2:
        input = argmax_last(input)
    if average == "micro":
        num_tp = torch.sum(input == target).to(torch.float32)
        num_label = torch.full((), float(target.shape[0]), device=target.device)
        return num_tp, num_label, num_label
    ones = torch.ones(target.shape, dtype=torch.float32, device=target.device)
    num_label = segment_sum(ones, target, num_classes)
    num_prediction = segment_sum(ones, input.to(target.dtype), num_classes)
    tp_mask = (input == target).to(torch.float32)
    num_tp = segment_sum(tp_mask, target, num_classes)
    return num_tp, num_label, num_prediction


def _f1_score_compute_jit(
    num_tp: torch.Tensor,
    num_label: torch.Tensor,
    num_prediction: torch.Tensor,
    average: Optional[str],
) -> torch.Tensor:
    precision = nan_safe_divide(num_tp, num_prediction)
    recall = nan_safe_divide(num_tp, num_label)
    f1 = torch.nan_to_num(2 * precision * recall / (precision + recall))
    if average == "micro":
        return f1
    if average == "macro":
        mask = (num_label != 0) | (num_prediction != 0)
        return torch.sum(torch.where(mask, f1, torch.zeros_like(f1))) / torch.clamp(
            torch.sum(mask), min=1
        )
    if average == "weighted":
        return torch.sum(f1 * (num_label / torch.sum(num_label)))
    return f1


def _f1_score_compute(
    num_tp: torch.Tensor,
    num_label: torch.Tensor,
    num_prediction: torch.Tensor,
    average: Optional[str],
) -> torch.Tensor:
    """``_f1_score_compute_jit`` behind the debug-tier notice about
    classes absent from the target."""
    if average != "micro" and debug_validation_enabled() and bool(torch.any(num_label == 0)):
        _logger.warning(
            "Warning: Some classes do not exist in the target. F1 scores for "
            "these classes will be cast to zeros."
        )
    return _f1_score_compute_jit(num_tp, num_label, num_prediction, average)


def _f1_score_param_check(num_classes: Optional[int], average: Optional[str]) -> None:
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


def _f1_score_update_input_check(
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


def multiclass_f1_score(
    input,
    target,
    *,
    num_classes: Optional[int] = None,
    average: Optional[str] = "micro",
    device: DeviceLike = None,
) -> torch.Tensor:
    """F1 score for multiclass classification (class version:
    ``MulticlassF1Score``).

    >>> import torch
    >>> from torcheval_tpu_torch.metrics.functional import multiclass_f1_score
    >>> multiclass_f1_score(torch.tensor([0, 2, 1, 3]), torch.tensor([0, 1, 2, 3]))
    tensor(0.5000)
    """
    dev = functional_device(device, input, target)
    input, target = to_torch(input, device=dev), to_torch(target, device=dev)
    _f1_score_param_check(num_classes, average)
    _f1_score_update_input_check(input, target, num_classes)
    num_tp, num_label, num_prediction = _f1_score_update_jit(
        input, target, num_classes, average
    )
    return _f1_score_compute(num_tp, num_label, num_prediction, average)


def _binary_f1_score_update_jit(
    input: torch.Tensor, target: torch.Tensor, threshold: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    pred = torch.where(input < threshold, 0, 1)
    num_tp = torch.sum(pred * target).to(torch.float32)
    num_label = torch.sum(target).to(torch.float32)
    num_prediction = torch.sum(pred).to(torch.float32)
    return num_tp, num_label, num_prediction


def _binary_f1_score_update_input_check(
    input: torch.Tensor, target: torch.Tensor
) -> None:
    if input.ndim != 1:
        raise ValueError(
            "input should be a one-dimensional tensor for binary f1 score, "
            f"got shape {tuple(input.shape)}."
        )
    if target.ndim != 1:
        raise ValueError(
            "target should be a one-dimensional tensor for binary f1 score, "
            f"got shape {tuple(target.shape)}."
        )
    if input.shape != target.shape:
        raise ValueError(
            "The `input` and `target` should have the same dimensions, "
            f"got shapes {tuple(input.shape)} and {tuple(target.shape)}."
        )


def binary_f1_score(
    input, target, *, threshold: float = 0.5, device: DeviceLike = None
) -> torch.Tensor:
    """Binary F1 score (class version: ``BinaryF1Score``).

    >>> import torch
    >>> from torcheval_tpu_torch.metrics.functional import binary_f1_score
    >>> binary_f1_score(torch.tensor([0.2, 0.8, 0.6, 0.3]), torch.tensor([0, 1, 1, 0]))
    tensor(1.)
    """
    dev = functional_device(device, input, target)
    input, target = to_torch(input, device=dev), to_torch(target, device=dev)
    _binary_f1_score_update_input_check(input, target)
    num_tp, num_label, num_prediction = _binary_f1_score_update_jit(
        input, target, float(threshold)
    )
    return _f1_score_compute_jit(num_tp, num_label, num_prediction, "micro")
