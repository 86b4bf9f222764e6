"""Number of id collisions (counterpart of
``torcheval_tpu/metrics/functional/ranking/num_collisions.py``).

The JAX package counts with a broadcast ``(N, N)`` compare that XLA fuses
away; eagerly that compare would allocate N^2 bools (4.3 GB for 65,536
ids), so here each id's count comes from one ``torch.unique`` (a sort)
and is read back through its inverse index: the same int32 values.
"""

from __future__ import annotations

import torch

from torcheval_tpu_torch.utils.convert import DeviceLike, functional_device, to_torch


def _num_collisions_input_check(input: torch.Tensor) -> None:
    if input.ndim != 1:
        raise ValueError(
            f"input should be a one-dimensional tensor, got shape {input.shape}."
        )
    if input.is_floating_point() or input.is_complex() or input.dtype == torch.bool:
        raise ValueError(f"input should be an integer tensor, got {input.dtype}.")


def num_collisions(input, *, device: DeviceLike = None) -> torch.Tensor:
    """For each id, the number of other occurrences of the same id
    (int32).

    >>> import torch
    >>> from torcheval_tpu_torch.metrics.functional import num_collisions
    >>> num_collisions(torch.tensor([3, 4, 2, 3]))
    tensor([1, 0, 0, 1], dtype=torch.int32)
    """
    input = to_torch(input, device=functional_device(device, input))
    _num_collisions_input_check(input)
    _, inverse, counts = torch.unique(input, return_inverse=True, return_counts=True)
    return (counts[inverse] - 1).to(torch.int32)
