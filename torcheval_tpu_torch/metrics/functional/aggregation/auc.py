"""Trapezoidal AUC over arbitrary (x, y) curves (counterpart of
``torcheval_tpu/metrics/functional/aggregation/auc.py``).

The optional reorder is a stable ascending sort of ``x``, taken as the
stable descending order of ``-x`` through the curve family's
``sort_desc``, so ties keep their index order as in the JAX package.
"""

from __future__ import annotations

import torch

from torcheval_tpu_torch.metrics.functional.classification._curve_kernels import (
    sort_desc,
)
from torcheval_tpu_torch.metrics.functional.tensor_utils import trapezoid
from torcheval_tpu_torch.utils.convert import DeviceLike, functional_device, narrow_64, to_torch


def _ascending_order(x: torch.Tensor) -> torch.Tensor:
    """Stable ascending argsort along the last axis: the stable descending
    order of ``-x``. Bool has no negation, so it counts as int32."""
    if x.dtype == torch.bool:
        x = x.to(torch.int32)
    _, order = sort_desc(-x)
    return order


def _auc_compute_2d(x: torch.Tensor, y: torch.Tensor, reorder: bool) -> torch.Tensor:
    if reorder:
        order = _ascending_order(x)
        x, y = torch.gather(x, 1, order), torch.gather(y, 1, order)
    return trapezoid(y, x, dim=1)


def _auc_compute_masked(
    x: torch.Tensor, y: torch.Tensor, count: int, reorder: bool
) -> torch.Tensor:
    """AUC over a padded (n_tasks, capacity) buffer whose first ``count``
    points are valid (``metrics/_buffer.py``): pad slots are clamped to the
    last valid point, so they form zero-width trapezoids wherever the
    stable sort places them."""
    n = x.shape[1]
    idx = torch.clamp(torch.arange(n, device=x.device), max=count - 1)
    idx = idx[None, :].expand(x.shape)
    x, y = torch.gather(x, 1, idx), torch.gather(y, 1, idx)
    return _auc_compute_2d(x, y, reorder)


def _auc_compute(x: torch.Tensor, y: torch.Tensor, reorder: bool = False) -> torch.Tensor:
    if x.numel() == 0 or y.numel() == 0:
        return torch.zeros((0,), device=x.device)
    if x.ndim == 1:
        x = x[None, :]
    if y.ndim == 1:
        y = y[None, :]
    return _auc_compute_2d(x, y, reorder)


def _auc_update_input_check(x: torch.Tensor, y: torch.Tensor, n_tasks: int = 1) -> None:
    size_x, size_y = tuple(x.shape), tuple(y.shape)
    if x.ndim == 1:
        x = x[None, :]
    if y.ndim == 1:
        y = y[None, :]
    if x.numel() == 0 or y.numel() == 0:
        raise ValueError(
            f"The `x` and `y` should have atleast 1 element, got shapes "
            f"{size_x} and {size_y}."
        )
    if x.shape != y.shape:
        raise ValueError(
            f"Expected the same shape in `x` and `y` tensor but got shapes "
            f"{size_x} and {size_y}."
        )
    if x.shape[0] != n_tasks or y.shape[0] != n_tasks:
        raise ValueError(
            f"Expected `x` dim_1={x.shape[0]} and `y` dim_1={y.shape[0]} have "
            f"first dimension equals to n_tasks={n_tasks}."
        )


def auc(x, y, reorder: bool = False, *, device: DeviceLike = None) -> torch.Tensor:
    """AUC of (x, y) point curves by the trapezoidal rule (class version:
    ``AUC``). ``x`` and ``y`` are (n,) or (n_tasks, n); ``reorder`` sorts
    ``x`` stably before integrating.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics.functional import auc
    >>> auc(torch.tensor([0., .1, .5, 1.]), torch.tensor([1., 1., .5, 0.]))
    tensor([0.5250])
    """
    dev = functional_device(device, x, y)
    x, y = narrow_64(to_torch(x, device=dev)), narrow_64(to_torch(y, device=dev))
    if x.dtype == torch.bool:
        # the trapezoid subtracts x; the JAX package's subtraction rejects
        # bool operands with a TypeError
        raise TypeError(f"auc does not accept a bool x, got x {x.dtype}.")
    _auc_update_input_check(x, y, n_tasks=1 if x.ndim == 1 else x.shape[0])
    return _auc_compute(x, y, reorder)
