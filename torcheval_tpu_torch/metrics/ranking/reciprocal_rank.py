"""ReciprocalRank class metric (counterpart of
``torcheval_tpu/metrics/ranking/reciprocal_rank.py``): the per-example
reciprocal ranks in a growable buffer (``metrics/_buffer.py``); the mean
of ``compute()`` is the MRR."""

from __future__ import annotations

from typing import Optional, TypeVar

import torch

from torcheval_tpu_torch.metrics._buffer import BufferedExamplesMetric
from torcheval_tpu_torch.metrics.functional.ranking.reciprocal_rank import (
    reciprocal_rank,
)
from torcheval_tpu_torch.utils.convert import DeviceLike

TReciprocalRank = TypeVar("TReciprocalRank", bound="ReciprocalRank")


class ReciprocalRank(BufferedExamplesMetric):
    """Concatenated per-example reciprocal ranks.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import ReciprocalRank
    >>> metric = ReciprocalRank(device="cpu")
    >>> _ = metric.update(torch.tensor([[0.3, 0.1, 0.6], [0.5, 0.2, 0.3]]),
    ...                   torch.tensor([2, 1]))
    >>> metric.compute()
    tensor([1.0000, 0.3333])
    """

    def __init__(self, *, k: Optional[int] = None, device: DeviceLike = None) -> None:
        super().__init__(device=device)
        self.k = k
        self._add_buffer("scores", fill=0.0, axis=0)

    def update(self: TReciprocalRank, input, target) -> TReciprocalRank:
        """Score one batch of predictions against targets."""
        self._append(
            scores=reciprocal_rank(self._input(input), self._input(target), k=self.k)
        )
        return self

    def compute(self) -> torch.Tensor:
        """All per-example scores; an empty tensor before any update."""
        if self.num_samples == 0:
            return torch.zeros(0, device=self.device)
        return self._valid()[0].clone()
