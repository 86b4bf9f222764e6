"""Frequency @ k (counterpart of
``torcheval_tpu/metrics/functional/ranking/frequency.py``)."""

from __future__ import annotations

import torch

from torcheval_tpu_torch.utils.convert import (
    DeviceLike,
    functional_device,
    narrow_64,
    to_torch,
)


def _frequency_input_check(input: torch.Tensor, k: float) -> None:
    if input.ndim != 1:
        raise ValueError(
            f"input should be a one-dimensional tensor, got shape {input.shape}."
        )
    if k < 0:
        raise ValueError(f"k should not be negative, got {k}.")


def frequency_at_k(input, k: float, *, device: DeviceLike = None) -> torch.Tensor:
    """1.0 where a frequency is below ``k``, else 0.0 (the comparison in
    float32, ``k`` a float32 scalar, as in the JAX package).

    >>> import torch
    >>> from torcheval_tpu_torch.metrics.functional import frequency_at_k
    >>> frequency_at_k(torch.tensor([0.3, 0.1, 0.6]), k=0.5)
    tensor([1., 1., 0.])
    """
    input = narrow_64(to_torch(input, device=functional_device(device, input)))
    _frequency_input_check(input, k)
    threshold = torch.full((), float(k), dtype=torch.float32, device=input.device)
    return (input < threshold).to(torch.float32)
