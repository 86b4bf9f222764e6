"""Cat class metric: a concatenation accumulator (counterpart of
``torcheval_tpu/metrics/aggregation/cat.py``). Inputs append along ``dim``
into a growable power-of-two buffer (``metrics/_buffer.py``); ``dim`` is
configuration carried as an int state with a CUSTOM merge, which the
buffered base resolves by keeping ours."""

from __future__ import annotations

from typing import TypeVar

import torch

from torcheval_tpu_torch.metrics._buffer import BufferedExamplesMetric
from torcheval_tpu_torch.metrics.metric import MergeKind
from torcheval_tpu_torch.utils.convert import DeviceLike

TCat = TypeVar("TCat", bound="Cat")


class Cat(BufferedExamplesMetric):
    """Concatenate all updated inputs along ``dim``.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import Cat
    >>> metric = Cat(device="cpu")
    >>> metric.update(torch.tensor([1., 2.])).update(torch.tensor([3.])).compute()
    tensor([1., 2., 3.])
    """

    def __init__(self, *, dim: int = 0, device: DeviceLike = None) -> None:
        super().__init__(device=device)
        self._add_state("dim", dim, merge=MergeKind.CUSTOM)
        self._add_buffer("inputs", fill=0.0, axis=dim)

    def update(self: TCat, input) -> TCat:
        BufferedExamplesMetric._append(self, inputs=self._input(input))
        return self

    def compute(self) -> torch.Tensor:
        if self.num_samples == 0:
            return torch.zeros((0,), device=self.device)
        return self._valid()[0]
