"""AUROC (area under the ROC curve).

Counterpart of ``torcheval_tpu/metrics/functional/classification/auroc.py``
(:30-198): binary (multi-task, weighted) and one-vs-rest multiclass, tie
runs handled by the run-end propagation of ``_curve_kernels``.
``use_fused=True`` (alias ``use_fbgemm``) takes the sort-free histogram
AUC of ``ops.fused_auc``, which on CUDA tensors launches the Hopper kernel
``ops/csrc/fused_auc_hist.cu``; it min/max-normalizes scores per task and
is exact up to its bin resolution.
"""

from __future__ import annotations

from typing import Optional

import torch

from torcheval_tpu_torch.metrics.functional.classification._curve_kernels import (
    _curve_inputs,
    binary_auroc_area,
)
from torcheval_tpu_torch.ops.fused_auc import fused_auc
from torcheval_tpu_torch.utils.convert import DeviceLike


def _binary_auroc_compute(
    input: torch.Tensor,
    target: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    use_fused: bool = False,
) -> torch.Tensor:
    if use_fused:
        return fused_auc(input, target, weight)
    return binary_auroc_area(input, target, weight)


def _binary_auroc_update_input_check(
    input: torch.Tensor,
    target: torch.Tensor,
    num_tasks: int,
    weight: Optional[torch.Tensor] = None,
) -> None:
    if input.shape != target.shape:
        raise ValueError(
            "The `input` and `target` should have the same shape, "
            f"got shapes {tuple(input.shape)} and {tuple(target.shape)}."
        )
    if weight is not None and weight.shape != target.shape:
        raise ValueError(
            "The `weight` and `target` should have the same shape, "
            f"got shapes {tuple(weight.shape)} and {tuple(target.shape)}."
        )
    if num_tasks == 1:
        if input.ndim > 1:
            raise ValueError(
                "`num_tasks = 1`, `input` is expected to be one-dimensional "
                f"tensor, but got shape ({tuple(input.shape)})."
            )
    elif input.ndim == 1 or input.shape[0] != num_tasks:
        raise ValueError(
            f"`num_tasks = {num_tasks}`, `input`'s shape is expected to be "
            f"({num_tasks}, num_samples), but got shape ({tuple(input.shape)})."
        )


def binary_auroc(
    input,
    target,
    *,
    num_tasks: int = 1,
    weight=None,
    use_fused: bool = False,
    use_fbgemm: Optional[bool] = None,
    device: DeviceLike = None,
) -> torch.Tensor:
    """AUROC for binary classification (class version: ``BinaryAUROC``).
    Scores (n,) or (num_tasks, n), 0/1 targets and optional weights of the
    same shape. ``use_fused`` takes the sort-free histogram kernel. Runs
    where the tensor inputs live; numpy and scalar inputs go to CUDA unless
    ``device="cpu"``.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics.functional import binary_auroc
    >>> binary_auroc(torch.tensor([0.1, 0.5, 0.7, 0.8]), torch.tensor([0, 0, 1, 1]))
    tensor(1.)
    """
    if use_fbgemm is not None:
        use_fused = use_fbgemm
    input, target, weight = _curve_inputs(device, input, target, weight)
    _binary_auroc_update_input_check(input, target, num_tasks, weight)
    return _binary_auroc_compute(input, target, weight, use_fused)


def _multiclass_auroc_compute(
    input: torch.Tensor,
    target: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-class one-vs-rest AUROC of (N, C) scores. ``valid`` is an
    optional (N,) mask of the buffered class metric: padded rows get
    weight 0, so they add to no class's curve."""
    num_classes = input.shape[1]
    scores = input.T
    classes = torch.arange(num_classes, device=input.device)
    targets = (target[None, :] == classes[:, None]).to(torch.float32)
    weight = None
    if valid is not None:
        weight = valid.to(torch.float32)[None, :].expand(scores.shape)
    return binary_auroc_area(scores, targets, weight)


def _multiclass_auroc_param_check(num_classes: int, average: Optional[str]) -> None:
    average_options = ("macro", "none", None)
    if average not in average_options:
        raise ValueError(
            f"`average` was not in the allowed value of {average_options}, "
            f"got {average}."
        )
    if num_classes is None or num_classes <= 1:
        raise ValueError(
            f"`num_classes` has to be at least 2, got {num_classes}."
        )


def _multiclass_auroc_update_input_check(
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


def multiclass_auroc(
    input,
    target,
    *,
    num_classes: int,
    average: Optional[str] = "macro",
    device: DeviceLike = None,
) -> torch.Tensor:
    """One-vs-rest AUROC for multiclass classification (class version:
    ``MulticlassAUROC``): the mean over classes for ``average="macro"``,
    else one value per class.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics.functional import multiclass_auroc
    >>> multiclass_auroc(torch.tensor([[0.1, 0.1], [0.5, 0.5]]), torch.tensor([0, 1]), num_classes=2)
    tensor(0.5000)
    """
    input, target = _curve_inputs(device, input, target)
    _multiclass_auroc_param_check(num_classes, average)
    _multiclass_auroc_update_input_check(input, target, num_classes)
    aurocs = _multiclass_auroc_compute(input, target)
    if average == "macro":
        return torch.mean(aurocs)
    return aurocs
