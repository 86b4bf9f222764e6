"""Binned AUROC: the trapezoidal AUROC over a fixed threshold grid.

Counterpart of ``torcheval_tpu/metrics/functional/classification/
binned_auroc.py``; the functional forms return ``(auroc, threshold)``.

- ``_binned_auroc_from_counts`` (:35): per-threshold tp/fp, flipped to
  ascending cumulative order with 0 prepended, trapezoid, 0.5 when there
  are no positives or no negatives.
- The dense computes (:51, :171) count ``input >= threshold[t]`` for every
  threshold at once, a ``(T, tasks, n)`` or ``(T, N, C)`` compare. At
  ImageNet-1k scale that cube holds 5e9 elements, so it is taken over
  chunks of thresholds of at most ``_COMPARE_CHUNK`` elements; each
  threshold's sums are independent, so the values do not change. Class
  counts are integer sums cast to float32, bitwise the JAX package's
  float32 sums while a count stays below 2^24.
- ``HistogramBinnedAUROC``'s pieces: ``_hist_binned_flat_index`` (:68),
  ``_hist_binned_update`` (:88, one ``segment_count``) and
  ``_hist_binned_auroc_compute`` (:103, integer suffix sums, then float32).
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import torch

from torcheval_tpu_torch.metrics.functional.classification.auroc import (
    _binary_auroc_update_input_check,
    _multiclass_auroc_update_input_check,
)
from torcheval_tpu_torch.metrics.functional.classification.binned_precision_recall_curve import (
    ThresholdLike,
    _bin_index,
    _one_hot,
    _suffix_sum,
)
from torcheval_tpu_torch.metrics.functional.tensor_utils import (
    create_threshold_tensor,
    trapezoid,
)
from torcheval_tpu_torch.ops.segment import safe_ids, segment_count
from torcheval_tpu_torch.utils.convert import (
    DeviceLike,
    functional_device,
    narrow_64,
    to_torch,
)

DEFAULT_NUM_THRESHOLD = 200
# elements of one chunk of the dense threshold compare (256 MB as bool)
_COMPARE_CHUNK = 1 << 28


def _binary_binned_auroc_param_check(num_tasks: int, threshold: torch.Tensor) -> None:
    if num_tasks < 1:
        raise ValueError(
            "`num_tasks` value should be greater than and equal to 1, but "
            f"received {num_tasks}. "
        )


def _binned_auroc_from_counts(tp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """tp/fp per ascending threshold, shape (..., T) -> AUROC (...)."""
    cum_tp = torch.flip(tp, (-1,))
    cum_fp = torch.flip(fp, (-1,))
    zeros = torch.zeros(cum_tp.shape[:-1] + (1,), dtype=cum_tp.dtype, device=cum_tp.device)
    cum_tp = torch.cat([zeros, cum_tp], dim=-1)
    cum_fp = torch.cat([zeros, cum_fp], dim=-1)
    factor = cum_tp[..., -1] * cum_fp[..., -1]
    area = trapezoid(cum_tp, cum_fp, dim=-1)
    degenerate = factor == 0
    return torch.where(
        degenerate,
        torch.full_like(area, 0.5),
        area / torch.where(degenerate, torch.ones_like(factor), factor),
    )


def _threshold_chunks(threshold: torch.Tensor, per_threshold: int) -> Iterator[torch.Tensor]:
    """Consecutive slices of ``threshold`` whose compare against
    ``per_threshold`` elements stays within ``_COMPARE_CHUNK``."""
    step = max(1, _COMPARE_CHUNK // max(per_threshold, 1))
    for start in range(0, threshold.shape[0], step):
        yield threshold[start:start + step]


def _binary_binned_auroc_compute_jit(
    input: torch.Tensor, target: torch.Tensor, threshold: torch.Tensor
) -> torch.Tensor:
    squeeze = input.ndim == 1
    if squeeze:
        input, target = input[None, :], target[None, :]
    input = narrow_64(input)
    tgt = target.to(torch.float32)
    tps, fps = [], []
    for thr in _threshold_chunks(threshold, input.numel()):
        pred = input[None, :, :] >= thr[:, None, None]  # (Tc, tasks, n)
        tp = torch.sum(pred * tgt[None], dim=-1)
        tps.append(tp)
        fps.append(torch.sum(pred, dim=-1).to(torch.float32) - tp)
    auroc = _binned_auroc_from_counts(torch.cat(tps).T, torch.cat(fps).T)  # (tasks,)
    return auroc[0] if squeeze else auroc


def _hist_binned_flat_index(
    input: torch.Tensor, target: torch.Tensor, threshold: torch.Tensor
) -> torch.Tensor:
    """Flat histogram cell per sample, ``target * T + bin`` with ``bin``
    the last threshold at or below the score (so ``score >= threshold[j]``
    iff ``bin >= j``, and suffix sums of the histogram are the dense
    counters); -1 below the grid (dropped)."""
    num_t = threshold.shape[0]
    b = _bin_index(input, threshold)
    flat = target.to(torch.int32) * num_t + b
    return torch.where(b < 0, torch.full_like(flat, -1), flat)


def _hist_binned_update(
    input: torch.Tensor, target: torch.Tensor, threshold: torch.Tensor
) -> torch.Tensor:
    """The ``(2T,)`` int32 histogram delta of one batch: negatives in
    ``[0, T)``, positives in ``[T, 2T)``; one ``segment_count``."""
    num_t = threshold.shape[0]
    idx = _hist_binned_flat_index(input, target, threshold)
    return segment_count(safe_ids(idx, 2 * num_t), 2 * num_t)


def _hist_binned_auroc_compute(hist: torch.Tensor, num_t: int) -> torch.Tensor:
    """AUROC from the ``(2T,)`` histogram: integer suffix sums rebuild the
    per-threshold tp/fp exactly, then the shared float32 trapezoid."""
    neg, pos = hist[:num_t], hist[num_t:]
    tp = _suffix_sum(pos, dim=0).to(torch.float32)
    fp = _suffix_sum(neg, dim=0).to(torch.float32)
    return _binned_auroc_from_counts(tp, fp)


def binary_binned_auroc(
    input,
    target,
    *,
    num_tasks: int = 1,
    threshold: ThresholdLike = DEFAULT_NUM_THRESHOLD,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Binned AUROC for binary classification: ``(auroc, threshold)``,
    the AUROC a scalar for one task (class version: ``BinaryBinnedAUROC``).

    >>> import torch
    >>> from torcheval_tpu_torch.metrics.functional import binary_binned_auroc
    >>> binary_binned_auroc(torch.tensor([0.1, 0.5, 0.7, 0.8]), torch.tensor([0, 0, 1, 1]),
    ...                     threshold=5)
    (tensor(0.8750), tensor([0.0000, 0.2500, 0.5000, 0.7500, 1.0000]))
    """
    dev = functional_device(device, input, target)
    input, target = to_torch(input, device=dev), to_torch(target, device=dev)
    threshold = create_threshold_tensor(threshold, device=dev)
    _binary_binned_auroc_param_check(num_tasks, threshold)
    _binary_auroc_update_input_check(input, target, num_tasks)
    return _binary_binned_auroc_compute_jit(input, target, threshold), threshold


def _multiclass_binned_auroc_param_check(
    num_classes: int, threshold: torch.Tensor, average: Optional[str]
) -> None:
    average_options = ("macro", "none", None)
    if average not in average_options:
        raise ValueError(
            f"`average` was not in the allowed value of {average_options}, "
            f"got {average}."
        )
    if num_classes < 2:
        raise ValueError(f"`num_classes` has to be at least 2, got {num_classes}.")


def _multiclass_binned_auroc_compute_jit(
    input: torch.Tensor, target: torch.Tensor, threshold: torch.Tensor
) -> torch.Tensor:
    """Per-class one-vs-rest AUROC (C,) of (N, C) scores."""
    input = narrow_64(input)
    onehot = _one_hot(target, input.shape[1])
    tps, fps = [], []
    for thr in _threshold_chunks(threshold, input.numel()):
        pred = input[None, :, :] >= thr[:, None, None]  # (Tc, N, C)
        tp = torch.sum(pred & onehot[None], dim=1).to(torch.float32)
        tps.append(tp)
        fps.append(torch.sum(pred, dim=1).to(torch.float32) - tp)
    return _binned_auroc_from_counts(torch.cat(tps).T, torch.cat(fps).T)


def multiclass_binned_auroc(
    input,
    target,
    *,
    num_classes: int,
    threshold: ThresholdLike = DEFAULT_NUM_THRESHOLD,
    average: Optional[str] = "macro",
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Binned one-vs-rest AUROC for multiclass classification, per class
    (the JAX package's reading, not the reference's class-axis sum):
    ``(auroc, threshold)`` (class version: ``MulticlassBinnedAUROC``).

    >>> import torch
    >>> from torcheval_tpu_torch.metrics.functional import multiclass_binned_auroc
    >>> multiclass_binned_auroc(torch.tensor([[0.8, 0.1, 0.1], [0.2, 0.7, 0.1],
    ...     [0.1, 0.2, 0.7], [0.3, 0.5, 0.2]]), torch.tensor([0, 1, 2, 1]),
    ...     num_classes=3, threshold=5)
    (tensor(1.), tensor([0.0000, 0.2500, 0.5000, 0.7500, 1.0000]))
    """
    dev = functional_device(device, input, target)
    input, target = to_torch(input, device=dev), to_torch(target, device=dev)
    threshold = create_threshold_tensor(threshold, device=dev)
    _multiclass_binned_auroc_param_check(num_classes, threshold, average)
    _multiclass_auroc_update_input_check(input, target, num_classes)
    auroc = _multiclass_binned_auroc_compute_jit(input, target, threshold)
    if average == "macro":
        return torch.mean(auroc), threshold
    return auroc, threshold
