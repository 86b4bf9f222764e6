"""AUPRC (area under the precision-recall curve, by Riemann sum).

Counterpart of ``torcheval_tpu/metrics/functional/classification/auprc.py``
(:25-208): binary (multi-task), one-vs-rest multiclass and per-label
multilabel, each one batched computation over tasks, classes or labels on
the last axis (repeated points of a tie run integrate to zero; see
``_curve_kernels``).
"""

from __future__ import annotations

from typing import Optional

import torch

from torcheval_tpu_torch.metrics.functional.classification._curve_kernels import (
    _curve_inputs,
    binary_auprc_area,
)
from torcheval_tpu_torch.utils.convert import DeviceLike


def _binary_auprc_compute(input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return binary_auprc_area(input, target)


def _binary_auprc_update_input_check(
    input: torch.Tensor, target: torch.Tensor, num_tasks: int
) -> None:
    if input.shape != target.shape:
        raise ValueError(
            "The `input` and `target` should have the same shape, "
            f"got shapes {tuple(input.shape)} and {tuple(target.shape)}."
        )
    if num_tasks == 1:
        if input.ndim == 2 and input.shape[0] > 1:
            raise ValueError(
                "`num_tasks = 1`, `input` and `target` are expected to be "
                "one-dimensional tensors or 1xN tensors, but got shape "
                f"input: {tuple(input.shape)}, target: {tuple(target.shape)}."
            )
        if input.ndim > 2:
            raise ValueError(
                "input should be at most two-dimensional, got shape "
                f"{tuple(input.shape)}."
            )
    elif input.ndim != 2 or input.shape[0] != num_tasks:
        raise ValueError(
            f"`num_tasks = {num_tasks}`, `input`'s shape is expected to be "
            f"({num_tasks}, num_samples), but got shape ({tuple(input.shape)})."
        )


def binary_auprc(
    input, target, *, num_tasks: int = 1, device: DeviceLike = None
) -> torch.Tensor:
    """AUPRC for binary classification (class version: ``BinaryAUPRC``),
    over the last axis of (n,) or (num_tasks, n) scores.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics.functional import binary_auprc
    >>> binary_auprc(torch.tensor([0.1, 0.5, 0.7, 0.8]), torch.tensor([1, 0, 1, 1]))
    tensor(0.9167)
    """
    input, target = _curve_inputs(device, input, target)
    _binary_auprc_update_input_check(input, target, num_tasks)
    return _binary_auprc_compute(input, target)


def _multiclass_auprc_param_check(num_classes: int, average: Optional[str]) -> None:
    average_options = ("macro", "none", None)
    if average not in average_options:
        raise ValueError(
            f"`average` was not in the allowed value of {average_options}, "
            f"got {average}."
        )
    if num_classes < 2:
        raise ValueError(f"`num_classes` has to be at least 2, got {num_classes}.")


def _multiclass_auprc_update_input_check(
    input: torch.Tensor, target: torch.Tensor, num_classes: int
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
    if input.ndim != 2 or input.shape[1] != num_classes:
        raise ValueError(
            f"input should have shape of (num_sample, num_classes), "
            f"got {tuple(input.shape)} and num_classes={num_classes}."
        )


def _multiclass_auprc_compute(input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-class one-vs-rest AUPRC of (N, C) scores."""
    classes = torch.arange(input.shape[1], device=input.device)
    targets = (target[None, :] == classes[:, None]).to(torch.int32)
    return binary_auprc_area(input.T, targets)


def _average(values: torch.Tensor, average: Optional[str]) -> torch.Tensor:
    return torch.mean(values) if average == "macro" else values


def multiclass_auprc(
    input,
    target,
    *,
    num_classes: Optional[int] = None,
    average: Optional[str] = "macro",
    device: DeviceLike = None,
) -> torch.Tensor:
    """One-vs-rest AUPRC for multiclass classification (class version:
    ``MulticlassAUPRC``).

    >>> import torch
    >>> from torcheval_tpu_torch.metrics.functional import multiclass_auprc
    >>> multiclass_auprc(torch.tensor([[0.8, 0.1, 0.1], [0.2, 0.7, 0.1],
    ...                  [0.1, 0.2, 0.7], [0.3, 0.5, 0.2]]), torch.tensor([0, 1, 2, 1]), num_classes=3)
    tensor(1.)
    """
    input, target = _curve_inputs(device, input, target)
    if num_classes is None and input.ndim == 2:
        num_classes = input.shape[1]
    _multiclass_auprc_param_check(num_classes, average)
    _multiclass_auprc_update_input_check(input, target, num_classes)
    return _average(_multiclass_auprc_compute(input, target), average)


def _multilabel_auprc_param_check(num_labels: int, average: Optional[str]) -> None:
    average_options = ("macro", "none", None)
    if average not in average_options:
        raise ValueError(
            f"`average` was not in the allowed value of {average_options}, "
            f"got {average}."
        )
    if num_labels < 1:
        raise ValueError(f"`num_labels` has to be at least 1, got {num_labels}.")


def _multilabel_auprc_update_input_check(
    input: torch.Tensor, target: torch.Tensor, num_labels: int
) -> None:
    if input.shape != target.shape:
        raise ValueError(
            "Expected both input.shape and target.shape to have the same shape"
            f" but got {tuple(input.shape)} and {tuple(target.shape)}."
        )
    if input.ndim != 2 or input.shape[1] != num_labels:
        raise ValueError(
            f"input should have shape of (num_sample, num_labels), "
            f"got {tuple(input.shape)} and num_labels={num_labels}."
        )


def _multilabel_auprc_compute(input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-label AUPRC of (N, L) scores and labels."""
    return binary_auprc_area(input.T, target.T)


def multilabel_auprc(
    input,
    target,
    *,
    num_labels: Optional[int] = None,
    average: Optional[str] = "macro",
    device: DeviceLike = None,
) -> torch.Tensor:
    """Per-label AUPRC for multilabel classification (class version:
    ``MultilabelAUPRC``).

    >>> import torch
    >>> from torcheval_tpu_torch.metrics.functional import multilabel_auprc
    >>> multilabel_auprc(torch.tensor([[0.9, 0.2, 0.8], [0.1, 0.7, 0.3], [0.6, 0.5, 0.4]]),
    ...                  torch.tensor([[1, 0, 1], [0, 1, 0], [1, 0, 1]]), num_labels=3)
    tensor(1.)
    """
    input, target = _curve_inputs(device, input, target)
    if input.ndim != 2:
        raise ValueError(
            f"input should be a two-dimensional tensor, got shape {tuple(input.shape)}."
        )
    if num_labels is None:
        num_labels = input.shape[1]
    _multilabel_auprc_param_check(num_labels, average)
    _multilabel_auprc_update_input_check(input, target, num_labels)
    return _average(_multilabel_auprc_compute(input, target), average)
