"""Accuracy (multiclass, binary and multilabel).

Counterpart of ``torcheval_tpu/metrics/functional/classification/accuracy.py``
(``_multiclass_accuracy_update`` :49, ``_accuracy_compute`` :109, the param
and input checks, ``multiclass_accuracy``, ``binary_accuracy``,
``multilabel_accuracy`` :410, ``topk_multilabel_accuracy`` :443). Per-class
counts use ``segment_sum`` with the JAX package's drop semantics for
targets outside ``[0, num_classes)``; top-k correctness uses the same
rank-count rule (an example is correct iff fewer than k classes score
strictly above the target's score). Top-k multilabel predictions are the
``k`` labels ``ops.topk`` picks (``lax.top_k`` order: ties to the lower
index).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from torcheval_tpu_torch.config import debug_validation_enabled
from torcheval_tpu_torch.metrics.functional.tensor_utils import (
    correct_mask,
    segment_sum,
)
from torcheval_tpu_torch.ops.topk import topk
from torcheval_tpu_torch.utils.convert import DeviceLike, functional_device, to_torch



def _debug_check_target_range(target: torch.Tensor, num_classes: Optional[int]) -> None:
    """Value-level label check: it reads the targets back to the host, so
    it runs only under ``config.debug_validation``."""
    if not debug_validation_enabled() or num_classes is None:
        return
    lo, hi = int(torch.min(target)), int(torch.max(target))
    if lo < 0 or hi >= num_classes:
        raise ValueError(
            f"target values must be in [0, {num_classes}), got range "
            f"[{lo}, {hi}]."
        )


# ---------------------------------------------------------------- multiclass


def _multiclass_accuracy_update(
    input: torch.Tensor,
    target: torch.Tensor,
    average: Optional[str],
    num_classes: Optional[int],
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    if k == 1:
        if input.ndim == 2:
            mask = correct_mask(input, target)
        else:
            mask = (input == target).to(torch.float32)
    else:
        # gather as jnp.take_along_axis does: negative targets in [-C, 0)
        # wrap, anything else outside [0, C) reads NaN
        c = input.shape[1]
        idx = torch.where(target < 0, target + c, target)
        in_range = (idx >= 0) & (idx < c)
        idx = torch.where(in_range, idx, torch.zeros_like(idx))
        target_score = torch.gather(input, 1, idx.to(torch.int64)[:, None])
        target_score = torch.where(
            in_range[:, None], target_score, torch.full_like(target_score, float("nan"))
        )
        rank = torch.sum(input > target_score, dim=-1)
        mask = (rank < k).to(torch.float32)

    if average == "micro":
        return (
            torch.sum(mask),
            torch.full((), float(target.shape[0]), device=mask.device),
        )
    num_correct = segment_sum(mask, target, num_classes)
    num_total = segment_sum(torch.ones_like(mask), target, num_classes)
    return num_correct, num_total


def _accuracy_compute(
    num_correct: torch.Tensor, num_total: torch.Tensor, average: Optional[str]
) -> torch.Tensor:
    if average == "macro":
        mask = num_total != 0
        per_class = torch.where(
            mask,
            num_correct / torch.where(mask, num_total, torch.ones_like(num_total)),
            torch.zeros_like(num_correct),
        )
        return torch.sum(per_class) / torch.clamp(torch.sum(mask), min=1)
    return num_correct / num_total


def _accuracy_param_check(
    average: Optional[str], num_classes: Optional[int], k: int = 1
) -> None:
    average_options = ("micro", "macro", "none", None)
    if average not in average_options:
        raise ValueError(
            f"`average` was not in the allowed value of {average_options}, "
            f"got {average}."
        )
    if average != "micro" and (num_classes is None or num_classes <= 0):
        raise ValueError(
            f"num_classes should be a positive number when average={average}. "
            f"Got num_classes={num_classes}."
        )
    if type(k) is not int:
        raise TypeError(f"Expected `k` to be an integer, but {type(k)} was provided.")
    if k < 1:
        raise ValueError(
            f"Expected `k` to be an integer greater than 0, but {k} was provided."
        )


def _accuracy_update_input_check(
    input: torch.Tensor,
    target: torch.Tensor,
    num_classes: Optional[int],
    k: int = 1,
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
    if k > 1 and input.ndim != 2:
        raise ValueError(
            "input should have shape (num_sample, num_classes) for k > 1, "
            f"got shape {tuple(input.shape)}."
        )
    if k > 1 and k > input.shape[1]:
        raise ValueError(
            f"k ({k}) should not be greater than the number of classes "
            f"({input.shape[1]})."
        )
    if not input.ndim == 1 and not (
        input.ndim == 2 and (num_classes is None or input.shape[1] == num_classes)
    ):
        raise ValueError(
            "input should have shape of (num_sample,) or (num_sample, num_classes), "
            f"got {tuple(input.shape)}."
        )
    _debug_check_target_range(target, num_classes)


def multiclass_accuracy(
    input,
    target,
    *,
    average: Optional[str] = "micro",
    num_classes: Optional[int] = None,
    k: int = 1,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Accuracy for multiclass classification (class version:
    ``MulticlassAccuracy``). Runs where the tensor inputs live; numpy and
    scalar inputs go to CUDA unless ``device="cpu"``.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics.functional import multiclass_accuracy
    >>> multiclass_accuracy(torch.tensor([0, 2, 1, 3]), torch.tensor([0, 1, 2, 3]))
    tensor(0.5000)
    """
    dev = functional_device(device, input, target)
    input, target = to_torch(input, device=dev), to_torch(target, device=dev)
    _accuracy_param_check(average, num_classes, k)
    _accuracy_update_input_check(input, target, num_classes, k)
    num_correct, num_total = _multiclass_accuracy_update(
        input, target, average, num_classes, k
    )
    return _accuracy_compute(num_correct, num_total, average)


# -------------------------------------------------------------------- binary


def _binary_accuracy_update(
    input: torch.Tensor, target: torch.Tensor, threshold: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    pred = torch.where(input < threshold, 0, 1)
    num_correct = torch.sum((pred == target).to(torch.float32))
    return num_correct, torch.full((), float(target.shape[0]), device=input.device)


def _binary_accuracy_update_input_check(
    input: torch.Tensor, target: torch.Tensor
) -> None:
    if input.shape != target.shape:
        raise ValueError(
            "The `input` and `target` should have the same dimensions, "
            f"got shapes {tuple(input.shape)} and {tuple(target.shape)}."
        )
    if target.ndim != 1:
        raise ValueError(
            f"target should be a one-dimensional tensor, got shape {tuple(target.shape)}."
        )


def binary_accuracy(
    input, target, *, threshold: float = 0.5, device: DeviceLike = None
) -> torch.Tensor:
    """Binary accuracy, scores binarized at ``threshold`` (class version:
    ``BinaryAccuracy``).

    >>> import torch
    >>> from torcheval_tpu_torch.metrics.functional import binary_accuracy
    >>> binary_accuracy(torch.tensor([0.9, 0.2, 0.6, 0.1]), torch.tensor([1, 0, 0, 1]))
    tensor(0.5000)
    """
    dev = functional_device(device, input, target)
    input, target = to_torch(input, device=dev), to_torch(target, device=dev)
    _binary_accuracy_update_input_check(input, target)
    num_correct, num_total = _binary_accuracy_update(input, target, float(threshold))
    return num_correct / num_total


# ---------------------------------------------------------------- multilabel


def _multilabel_update(
    input_label: torch.Tensor, target: torch.Tensor, criteria: str
) -> Tuple[torch.Tensor, torch.Tensor]:
    n = torch.full((), float(target.shape[0]), device=target.device)
    if criteria == "exact_match":
        return torch.sum(torch.all(input_label == target, dim=1)).to(torch.float32), n
    if criteria == "hamming":
        num_correct = torch.sum(input_label == target).to(torch.float32)
        return num_correct, torch.full((), float(target.numel()), device=target.device)
    if criteria == "overlap":
        hit = torch.any((input_label == target) & (input_label == 1), dim=1)
        all_negative = torch.all((input_label == 0) & (target == 0), dim=1)
        return torch.sum(hit | all_negative).to(torch.float32), n
    if criteria == "contain":
        return torch.sum(torch.all(input_label - target >= 0, dim=1)).to(torch.float32), n
    # belong
    return torch.sum(torch.all(input_label - target <= 0, dim=1)).to(torch.float32), n


def _multilabel_accuracy_update(
    input: torch.Tensor, target: torch.Tensor, threshold: float, criteria: str
) -> Tuple[torch.Tensor, torch.Tensor]:
    input_label = torch.where(input < threshold, 0, 1)
    return _multilabel_update(input_label, target, criteria)


def _topk_multilabel_accuracy_update(
    input: torch.Tensor, target: torch.Tensor, criteria: str, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    # exactly k predicted labels a row, ties to the lower index
    _, idx = topk(input, k)
    input_label = torch.zeros(input.shape, dtype=target.dtype, device=input.device)
    input_label.scatter_(1, idx.to(torch.int64), 1)
    return _multilabel_update(input_label, target, criteria)


def _multilabel_accuracy_param_check(criteria: str) -> None:
    criteria_options = ("exact_match", "hamming", "overlap", "contain", "belong")
    if criteria not in criteria_options:
        raise ValueError(
            f"`criteria` was not in the allowed value of {criteria_options}, "
            f"got {criteria}."
        )


def _multilabel_accuracy_update_input_check(input: torch.Tensor, target: torch.Tensor) -> None:
    if input.shape != target.shape:
        raise ValueError(
            "The `input` and `target` should have the same dimensions, "
            f"got shapes {tuple(input.shape)} and {tuple(target.shape)}."
        )


def _topk_multilabel_accuracy_param_check(criteria: str, k: int) -> None:
    _multilabel_accuracy_param_check(criteria)
    if type(k) is not int:
        raise TypeError(f"Expected `k` to be an integer, but {type(k)} was provided.")
    if k < 2:
        raise ValueError(
            f"Expected `k` to be an integer greater than 1, but {k} was provided."
        )


def _topk_multilabel_accuracy_update_input_check(
    input: torch.Tensor, target: torch.Tensor, k: int
) -> None:
    _multilabel_accuracy_update_input_check(input, target)
    if input.ndim != 2:
        raise ValueError(
            f"input should be a two-dimensional tensor, got shape {tuple(input.shape)}."
        )
    if input.shape[1] < k:
        raise ValueError(
            "input should have at least k classes in dimension 1, "
            f"got shape {tuple(input.shape)} with k={k}."
        )


def multilabel_accuracy(
    input,
    target,
    *,
    threshold: float = 0.5,
    criteria: str = "exact_match",
    device: DeviceLike = None,
) -> torch.Tensor:
    """Multilabel accuracy of scores binarized at ``threshold`` (class
    version: ``MultilabelAccuracy``). ``criteria``: ``exact_match`` (every
    label matches), ``hamming`` (the share of matching labels),
    ``overlap`` (a positive label in common, or both all negative),
    ``contain`` (the predictions contain every target), ``belong`` (the
    predictions are a subset of the targets).

    >>> import torch
    >>> from torcheval_tpu_torch.metrics.functional import multilabel_accuracy
    >>> multilabel_accuracy(torch.tensor([[0.1, 0.9], [0.8, 0.9]]), torch.tensor([[0, 1], [1, 1]]))
    tensor(1.)
    """
    dev = functional_device(device, input, target)
    input, target = to_torch(input, device=dev), to_torch(target, device=dev)
    _multilabel_accuracy_param_check(criteria)
    _multilabel_accuracy_update_input_check(input, target)
    num_correct, num_total = _multilabel_accuracy_update(input, target, float(threshold), criteria)
    return num_correct / num_total


def topk_multilabel_accuracy(
    input,
    target,
    *,
    criteria: str = "exact_match",
    k: int = 2,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Multilabel accuracy with the ``k`` top-scored labels of each row
    predicted positive (class version: ``TopKMultilabelAccuracy``).

    >>> import torch
    >>> from torcheval_tpu_torch.metrics.functional import topk_multilabel_accuracy
    >>> topk_multilabel_accuracy(torch.tensor([[0.9, 0.2, 0.8], [0.1, 0.7, 0.3],
    ...     [0.6, 0.5, 0.4]]), torch.tensor([[1, 0, 1], [0, 1, 0], [1, 0, 1]]),
    ...     criteria="hamming", k=2)
    tensor(0.6667)
    """
    dev = functional_device(device, input, target)
    input, target = to_torch(input, device=dev), to_torch(target, device=dev)
    _topk_multilabel_accuracy_param_check(criteria, k)
    _topk_multilabel_accuracy_update_input_check(input, target, k)
    num_correct, num_total = _topk_multilabel_accuracy_update(input, target, criteria, k)
    return num_correct / num_total
