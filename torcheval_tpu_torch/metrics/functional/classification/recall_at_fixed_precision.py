"""Recall at fixed precision.

Counterpart of ``torcheval_tpu/metrics/functional/classification/
recall_at_fixed_precision.py`` (:30-110): the max-recall and best-threshold
selection runs over the full-length curve arrays with run-end masks, on the
device, instead of the reference's boolean indexing.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from torcheval_tpu_torch.metrics.functional.classification._curve_kernels import (
    _curve_inputs,
    prc_arrays,
    recall_at_precision_from_arrays,
)
from torcheval_tpu_torch.metrics.functional.classification.precision_recall_curve import (
    _binary_precision_recall_curve_update_input_check,
    _multilabel_precision_recall_curve_update_input_check,
)
from torcheval_tpu_torch.utils.convert import DeviceLike


def _rafp_compute(
    input: torch.Tensor, target: torch.Tensor, min_precision: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(recall, threshold) over the last axis: scalars for (n,) inputs,
    one per row for (rows, n)."""
    p, r, t, is_end = prc_arrays(input, target, 1)
    return recall_at_precision_from_arrays(p, r, t, is_end, min_precision)


def _min_precision_check(min_precision: float) -> None:
    if not isinstance(min_precision, float) or not (0 <= min_precision <= 1):
        raise ValueError(
            "Expected min_precision to be a float in the [0, 1] range"
            f" but got {min_precision}."
        )


def _binary_recall_at_fixed_precision_update_input_check(
    input: torch.Tensor, target: torch.Tensor, min_precision: float
) -> None:
    _binary_precision_recall_curve_update_input_check(input, target)
    _min_precision_check(min_precision)


def binary_recall_at_fixed_precision(
    input, target, *, min_precision: float, device: DeviceLike = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Max recall subject to ``precision >= min_precision``, and the
    largest threshold attaining it (class version:
    ``BinaryRecallAtFixedPrecision``).

    >>> import torch
    >>> from torcheval_tpu_torch.metrics.functional import binary_recall_at_fixed_precision
    >>> binary_recall_at_fixed_precision(
    ...     torch.tensor([0.1, 0.4, 0.6, 0.6, 0.6, 0.35, 0.8]),
    ...     torch.tensor([0, 0, 1, 1, 1, 1, 1]), min_precision=0.5)
    (tensor(1.), tensor(0.3500))
    """
    input, target = _curve_inputs(device, input, target)
    _binary_recall_at_fixed_precision_update_input_check(input, target, min_precision)
    return _rafp_compute(input, target, float(min_precision))


def multilabel_recall_at_fixed_precision(
    input, target, *, num_labels: int, min_precision: float, device: DeviceLike = None
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Per-label max recall at fixed precision (class version:
    ``MultilabelRecallAtFixedPrecision``): lists of recalls and
    thresholds, one entry per label.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics.functional import multilabel_recall_at_fixed_precision
    >>> multilabel_recall_at_fixed_precision(torch.tensor([[0.9, 0.2, 0.8], [0.1, 0.7, 0.3],
    ...     [0.6, 0.5, 0.4]]), torch.tensor([[1, 0, 1], [0, 1, 0], [1, 0, 1]]),
    ...     num_labels=3, min_precision=0.5)[1]
    [tensor(0.6000), tensor(0.7000), tensor(0.4000)]
    """
    input, target = _curve_inputs(device, input, target)
    if num_labels is None and input.ndim == 2:
        num_labels = input.shape[1]
    _multilabel_precision_recall_curve_update_input_check(input, target, num_labels)
    _min_precision_check(min_precision)
    recalls, thresholds = _rafp_compute(input.T, target.T, float(min_precision))
    return list(recalls), list(thresholds)
