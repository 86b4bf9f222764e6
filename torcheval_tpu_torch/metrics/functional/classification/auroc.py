"""AUROC input checks.

Counterpart of ``torcheval_tpu/metrics/functional/classification/auroc.py``
for this slice: only ``_binary_auroc_update_input_check`` (:50), which the
streaming AUC metrics share. Exact ``binary_auroc`` needs the sort and
curve kernels of ``_curve_kernels.py`` and lands with the curve family in
a later slice.
"""

from __future__ import annotations

from typing import Optional

import torch


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
