"""Retrieval precision (precision @ k).

Counterpart of ``torcheval_tpu/metrics/functional/ranking/
retrieval_precision.py``: the top ``k`` by ``ops.topk`` (``lax.top_k``
order: IEEE totalOrder, ties to the lower index), then the relevant count
over the number retrieved. The JAX package divides by a number fixed when
it traces, and XLA turns that division into a multiply by its float32
reciprocal; ``_precision`` multiplies the same way, so the values agree
bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from torcheval_tpu_torch.ops.topk import topk
from torcheval_tpu_torch.utils.convert import (
    DeviceLike,
    functional_device,
    narrow_64,
    to_torch,
)


def _retrieval_precision_param_check(
    k: Optional[int] = None, limit_k_to_size: bool = False
) -> None:
    if k is not None and k <= 0:
        raise ValueError(f"k must be a positive integer, got k={k}.")
    if limit_k_to_size and k is None:
        raise ValueError(
            "when limit_k_to_size is True, k must be a positive (>0) integer."
        )


def _retrieval_precision_update_input_check(
    input: torch.Tensor, target: torch.Tensor, num_tasks: int = 1
) -> None:
    if input.shape != target.shape:
        raise ValueError(
            "input and target must be of the same shape, got "
            f"input.shape={input.shape} and target.shape={target.shape}."
        )
    if num_tasks == 1:
        if input.ndim != 1:
            raise ValueError(
                "input and target should be one dimensional tensors, "
                f"got input and target dimensions={input.ndim}."
            )
    elif input.ndim != 2 or input.shape[0] != num_tasks:
        raise ValueError(
            "input and target should be two dimensional tensors with "
            f"{num_tasks} rows, got input and target shape={input.shape}."
        )


def get_topk(t: torch.Tensor, k: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top ``min(k, n)`` values and int32 indices along the last axis
    (``k=None``: all ``n``), in ``ops.topk`` order."""
    nb_samples = t.shape[-1]
    return topk(t, nb_samples if k is None else min(k, nb_samples))


def _nb_retrieved(nb_samples, k: Optional[int], limit_k_to_size: bool):
    """The divisor: ``n`` for ``k=None``, ``min(k, n)`` when limited, else
    ``k`` (``n`` an int or an int array)."""
    if k is None:
        return nb_samples
    if limit_k_to_size:
        return np.minimum(k, nb_samples)
    return k


def _precision(nb_relevant: torch.Tensor, nb_retrieved) -> torch.Tensor:
    """``nb_relevant / nb_retrieved`` as the JAX package computes it:
    times the float32 reciprocal of the divisor (a number or an array a
    row)."""
    with np.errstate(divide="ignore"):
        scale = np.float32(1.0) / np.asarray(nb_retrieved, dtype=np.float32)  # tev: disable=host-sync -- nb_retrieved is a host int or numpy array (k, or np.minimum(k, sizes)), never a device tensor
    scale_t = torch.as_tensor(np.asarray(scale), device=nb_relevant.device)  # tev: disable=host-sync -- the host reciprocal above, uploaded once
    return nb_relevant.to(torch.float32) * scale_t


def _retrieval_precision_compute(
    input: torch.Tensor,
    target: torch.Tensor,
    k: Optional[int] = None,
    limit_k_to_size: bool = False,
) -> torch.Tensor:
    _, topk_idx = get_topk(input, k)
    nb_relevant = torch.sum(torch.gather(target, -1, topk_idx.to(torch.int64)), dim=-1)
    return _precision(nb_relevant, _nb_retrieved(input.shape[-1], k, limit_k_to_size))


def retrieval_precision(
    input,
    target,
    k: Optional[int] = None,
    limit_k_to_size: bool = False,
    num_tasks: int = 1,
    *,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Share of relevant items among the top ``k`` retrieved, for scores
    and 0/1 labels of shape ``(n,)`` or ``(num_tasks, n)`` (class version:
    ``RetrievalPrecision``).

    Args:
        k: number of retrieved items considered (``None``: all).
        limit_k_to_size: divide by ``min(k, n)`` rather than ``k``.
        num_tasks: number of independent rows.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics.functional import retrieval_precision
    >>> retrieval_precision(torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2]),
    ...                     torch.tensor([0, 0, 1, 1, 1, 0, 1]), k=2)
    tensor(0.5000)
    """
    dev = functional_device(device, input, target)
    input = narrow_64(to_torch(input, device=dev))
    target = narrow_64(to_torch(target, device=dev))
    _retrieval_precision_param_check(k, limit_k_to_size)
    _retrieval_precision_update_input_check(input, target, num_tasks)
    return _retrieval_precision_compute(input, target, k, limit_k_to_size)
