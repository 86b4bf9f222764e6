"""Binned precision-recall curves: counters over a fixed threshold grid.

Counterpart of ``torcheval_tpu/metrics/functional/classification/
binned_precision_recall_curve.py``. Each update turns a batch into
per-threshold ``num_tp``/``num_fp``/``num_fn`` counts (float32, one row
of T thresholds per task, class or label), so the state is fixed-size and
merges by a sum.

- Binary: each score's bin is the last threshold at or below it
  (``searchsorted(side="right") - 1``, -1 below the grid and dropped);
  ``segment_sum`` histograms the fused ``2 * bin + target`` index and a
  flip-cumsum-flip suffix sum turns the histogram into counts at or above
  each threshold (:48-69).
- Multiclass and multilabel, in both ``optimization`` modes:
  ``vectorized`` compares the whole ``(T, N, C)`` cube at once (:147,
  :302); ``memory`` histograms the fused ``2 * (C * bin + c) + is_target``
  index (:160, :314) in O(N * C) memory.

Thresholds are searched as the JAX package searches them: -0.0 ties +0.0
and a NaN score lands past the last threshold, so the histogram forms
count it at every threshold, while the ``vectorized`` compare
(``NaN >= t`` is false) counts it at none -- the JAX package's two modes
differ there too, and the port keeps each. 64-bit scores are compared in
float32, the width the JAX package holds them in.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from torcheval_tpu_torch.metrics.functional.classification.precision_recall_curve import (
    _binary_precision_recall_curve_update_input_check,
    _multiclass_precision_recall_curve_update_input_check,
    _multilabel_precision_recall_curve_update_input_check,
)
from torcheval_tpu_torch.metrics.functional.tensor_utils import (
    create_threshold_tensor,
    nan_safe_divide,
    searchsorted_right,
)
from torcheval_tpu_torch.ops.segment import safe_ids, segment_sum
from torcheval_tpu_torch.utils.convert import (
    DeviceLike,
    functional_device,
    narrow_64,
    to_torch,
)

DEFAULT_NUM_THRESHOLD = 100

ThresholdLike = Union[int, List[float], torch.Tensor, np.ndarray]


def _optimization_param_check(optimization: str) -> None:
    if optimization not in ("vectorized", "memory"):
        raise ValueError(
            "Unknown memory approach: expected 'vectorized' or 'memory', but "
            f"got {optimization}."
        )


def _bin_index(input: torch.Tensor, threshold: torch.Tensor) -> torch.Tensor:
    """Largest ``i`` with ``input >= threshold[i]``, -1 below the grid
    (int64, the shape of ``input``)."""
    return searchsorted_right(threshold, input) - 1


def _suffix_sum(per_bin: torch.Tensor, dim: int) -> torch.Tensor:
    """Counts at or above each threshold: flip-cumsum-flip along ``dim``."""
    return torch.flip(torch.cumsum(torch.flip(per_bin, (dim,)), dim=dim), (dim,))


def _binary_binned_update_jit(
    input: torch.Tensor, target: torch.Tensor, threshold: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Counters of (n,) scores, or of each row of (tasks, n) scores (the
    JAX package maps the 1-D kernel over the rows): shape ``input.shape[:-1]
    + (T,)``."""
    num_t = threshold.shape[0]
    # the row count comes from the leading axes: ``reshape(-1, 0)`` cannot
    # infer it when the batch is empty
    n_rows = math.prod(input.shape[:-1])
    rows = input.reshape(n_rows, input.shape[-1])
    tgt = target.reshape(n_rows, input.shape[-1])
    idx = _bin_index(rows, threshold)
    fused = torch.clamp(2 * idx + tgt.to(torch.int32), 0, 2 * num_t - 1)
    fused = fused + 2 * num_t * torch.arange(rows.shape[0], device=rows.device)[:, None]
    valid = (idx >= 0).to(torch.float32)
    hist = segment_sum(valid.reshape(-1), fused.reshape(-1), rows.shape[0] * 2 * num_t)
    suffix = _suffix_sum(hist.reshape(rows.shape[0], num_t, 2), dim=1)
    num_fp, num_tp = suffix[..., 0], suffix[..., 1]
    num_fn = torch.sum(tgt, dim=-1).to(torch.float32)[:, None] - num_tp
    shape = input.shape[:-1] + (num_t,)
    return num_tp.reshape(shape), num_fp.reshape(shape), num_fn.reshape(shape)


def _binary_binned_compute_jit(
    num_tp: torch.Tensor, num_fp: torch.Tensor, num_fn: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    # precision is 1 where there are no predictions; the curve ends at
    # (precision 1, recall 0)
    precision = torch.nan_to_num(nan_safe_divide(num_tp, num_tp + num_fp), nan=1.0)
    recall = num_tp / (num_tp + num_fn)
    precision = torch.cat([precision, torch.ones_like(precision[..., :1])], -1)
    recall = torch.cat([recall, torch.zeros_like(recall[..., :1])], -1)
    return precision, recall


def binary_binned_precision_recall_curve(
    input,
    target,
    *,
    threshold: ThresholdLike = DEFAULT_NUM_THRESHOLD,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Binned precision-recall curve for binary classification:
    ``(precision, recall, threshold)`` (class version:
    ``BinaryBinnedPrecisionRecallCurve``).

    >>> import torch
    >>> from torcheval_tpu_torch.metrics.functional import binary_binned_precision_recall_curve
    >>> binary_binned_precision_recall_curve(torch.tensor([0.2, 0.8]), torch.tensor([0, 1]),
    ...                                      threshold=[0.0, 0.5, 1.0])
    (tensor([0.5000, 1.0000, 1.0000, 1.0000]), tensor([1., 1., 0., 0.]), tensor([0.0000, 0.5000, 1.0000]))
    """
    dev = functional_device(device, input, target)
    input, target = to_torch(input, device=dev), to_torch(target, device=dev)
    threshold = create_threshold_tensor(threshold, device=dev)
    _binary_precision_recall_curve_update_input_check(input, target)
    num_tp, num_fp, num_fn = _binary_binned_update_jit(narrow_64(input), target, threshold)
    precision, recall = _binary_binned_compute_jit(num_tp, num_fp, num_fn)
    return precision, recall, threshold


# ------------------------------------------------------ multiclass kernels


def _one_hot(target: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(N, C) bool, all False for a target outside ``[0, C)`` (as
    ``jax.nn.one_hot``; ``torch.nn.functional.one_hot`` would raise)."""
    return target[:, None] == torch.arange(num_classes, device=target.device)[None, :]


def _multiclass_binned_update_vectorized_jit(
    input: torch.Tensor, target: torch.Tensor, threshold: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    labels = input[None] >= threshold[:, None, None]  # (T, N, C)
    onehot = _one_hot(target, input.shape[1])
    num_tp = torch.sum(labels & onehot, dim=1).to(torch.float32)
    num_fp = torch.sum(labels, dim=1).to(torch.float32) - num_tp
    num_fn = torch.sum(onehot, dim=0).to(torch.float32) - num_tp
    return num_tp, num_fp, num_fn


def _fused_histogram_counts(
    idx: torch.Tensor, is_target: torch.Tensor, num_t: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(num_tp, num_fp)``, (T, C), from (N, C) bins and target flags:
    one ``segment_sum`` of the fused ``2 * (C * bin + c) + is_target``
    index, then suffix sums over the thresholds."""
    num_cols = idx.shape[1]
    cols = torch.arange(num_cols, device=idx.device)[None, :]
    fused = 2 * (num_cols * idx + cols) + is_target.to(torch.int32)
    valid = (idx >= 0).to(torch.float32)
    nbins = 2 * num_t * num_cols
    hist = segment_sum(valid.reshape(-1), torch.clamp(fused, 0, nbins - 1).reshape(-1), nbins)
    suffix = _suffix_sum(hist.reshape(num_t, num_cols, 2), dim=0)
    return suffix[..., 1], suffix[..., 0]


def _multiclass_binned_update_memory_jit(
    input: torch.Tensor, target: torch.Tensor, threshold: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    num_classes = input.shape[1]
    num_tp, num_fp = _fused_histogram_counts(
        _bin_index(input, threshold), _one_hot(target, num_classes), threshold.shape[0]
    )
    class_counts = segment_sum(
        torch.ones(target.shape, dtype=torch.float32, device=target.device),
        safe_ids(target, num_classes),
        num_classes,
    )
    return num_tp, num_fp, class_counts[None, :] - num_tp


_MULTICLASS_KERNELS = {
    "vectorized": _multiclass_binned_update_vectorized_jit,
    "memory": _multiclass_binned_update_memory_jit,
}


def _multiclass_binned_precision_recall_curve_update(
    input: torch.Tensor,
    target: torch.Tensor,
    num_classes: Optional[int],
    threshold: torch.Tensor,
    optimization: str = "vectorized",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _optimization_param_check(optimization)
    _multiclass_precision_recall_curve_update_input_check(input, target, num_classes)
    return _MULTICLASS_KERNELS[optimization](narrow_64(input), target, threshold)


def _multiclass_binned_precision_recall_curve_compute(
    num_tp: torch.Tensor,
    num_fp: torch.Tensor,
    num_fn: torch.Tensor,
    threshold: torch.Tensor,
) -> Tuple[List[torch.Tensor], List[torch.Tensor], torch.Tensor]:
    precision, recall = _binary_binned_compute_jit(num_tp.T, num_fp.T, num_fn.T)  # (C, T+1)
    return list(precision), list(recall), threshold


def multiclass_binned_precision_recall_curve(
    input,
    target,
    *,
    num_classes: Optional[int] = None,
    threshold: ThresholdLike = DEFAULT_NUM_THRESHOLD,
    optimization: str = "vectorized",
    device: DeviceLike = None,
) -> Tuple[List[torch.Tensor], List[torch.Tensor], torch.Tensor]:
    """Binned one-vs-rest precision-recall curves, one a class (class
    version: ``MulticlassBinnedPrecisionRecallCurve``).
    ``optimization="vectorized"`` compares a (T, N, C) cube (fast, T times
    the input's memory); ``"memory"`` histograms fused indices.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics.functional import multiclass_binned_precision_recall_curve
    >>> p, r, t = multiclass_binned_precision_recall_curve(
    ...     torch.tensor([[0.8, 0.1, 0.1], [0.2, 0.7, 0.1], [0.1, 0.2, 0.7], [0.3, 0.5, 0.2]]),
    ...     torch.tensor([0, 1, 2, 1]), num_classes=3, threshold=3)
    >>> p[1], r[1]
    (tensor([0.5000, 1.0000, 1.0000, 1.0000]), tensor([1., 1., 0., 0.]))
    """
    dev = functional_device(device, input, target)
    input, target = to_torch(input, device=dev), to_torch(target, device=dev)
    threshold = create_threshold_tensor(threshold, device=dev)
    if num_classes is None and input.ndim == 2:
        num_classes = input.shape[1]
    num_tp, num_fp, num_fn = _multiclass_binned_precision_recall_curve_update(
        input, target, num_classes, threshold, optimization
    )
    return _multiclass_binned_precision_recall_curve_compute(num_tp, num_fp, num_fn, threshold)


# ------------------------------------------------------ multilabel kernels


def _multilabel_binned_update_vectorized_jit(
    input: torch.Tensor, target: torch.Tensor, threshold: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    labels = input[None] >= threshold[:, None, None]  # (T, N, L)
    tbool = target.to(torch.bool)
    num_tp = torch.sum(labels & tbool, dim=1).to(torch.float32)
    num_fp = torch.sum(labels, dim=1).to(torch.float32) - num_tp
    num_fn = torch.sum(tbool, dim=0).to(torch.float32) - num_tp
    return num_tp, num_fp, num_fn


def _multilabel_binned_update_memory_jit(
    input: torch.Tensor, target: torch.Tensor, threshold: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    num_tp, num_fp = _fused_histogram_counts(
        _bin_index(input, threshold), target, threshold.shape[0]
    )
    label_counts = torch.sum(target, dim=0).to(torch.float32)
    return num_tp, num_fp, label_counts[None, :] - num_tp


_MULTILABEL_KERNELS = {
    "vectorized": _multilabel_binned_update_vectorized_jit,
    "memory": _multilabel_binned_update_memory_jit,
}


def _multilabel_binned_precision_recall_curve_update(
    input: torch.Tensor,
    target: torch.Tensor,
    num_labels: Optional[int],
    threshold: torch.Tensor,
    optimization: str = "vectorized",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _optimization_param_check(optimization)
    _multilabel_precision_recall_curve_update_input_check(input, target, num_labels)
    return _MULTILABEL_KERNELS[optimization](narrow_64(input), target, threshold)


def multilabel_binned_precision_recall_curve(
    input,
    target,
    *,
    num_labels: Optional[int] = None,
    threshold: ThresholdLike = DEFAULT_NUM_THRESHOLD,
    optimization: str = "vectorized",
    device: DeviceLike = None,
) -> Tuple[List[torch.Tensor], List[torch.Tensor], torch.Tensor]:
    """Binned precision-recall curves, one a label (class version:
    ``MultilabelBinnedPrecisionRecallCurve``).

    >>> import torch
    >>> from torcheval_tpu_torch.metrics.functional import multilabel_binned_precision_recall_curve
    >>> p, r, t = multilabel_binned_precision_recall_curve(
    ...     torch.tensor([[0.9, 0.2, 0.8], [0.1, 0.7, 0.3], [0.6, 0.5, 0.4]]),
    ...     torch.tensor([[1, 0, 1], [0, 1, 0], [1, 0, 1]]), num_labels=3, threshold=3)
    >>> p[2], r[2]
    (tensor([0.6667, 1.0000, 1.0000, 1.0000]), tensor([1.0000, 0.5000, 0.0000, 0.0000]))
    """
    dev = functional_device(device, input, target)
    input, target = to_torch(input, device=dev), to_torch(target, device=dev)
    threshold = create_threshold_tensor(threshold, device=dev)
    if num_labels is None and input.ndim == 2:
        num_labels = input.shape[1]
    num_tp, num_fp, num_fn = _multilabel_binned_precision_recall_curve_update(
        input, target, num_labels, threshold, optimization
    )
    return _multiclass_binned_precision_recall_curve_compute(num_tp, num_fp, num_fn, threshold)
