"""HitRate class metric (counterpart of
``torcheval_tpu/metrics/ranking/hit_rate.py``): the per-example scores in
a growable buffer (``metrics/_buffer.py``); ``compute`` returns them
all."""

from __future__ import annotations

from typing import Optional, TypeVar

import torch

from torcheval_tpu_torch.metrics._buffer import BufferedExamplesMetric
from torcheval_tpu_torch.metrics.functional.ranking.hit_rate import hit_rate
from torcheval_tpu_torch.utils.convert import DeviceLike

THitRate = TypeVar("THitRate", bound="HitRate")


class HitRate(BufferedExamplesMetric):
    """Concatenated per-example hit-rate scores.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import HitRate
    >>> metric = HitRate(k=2, device="cpu")
    >>> _ = metric.update(torch.tensor([[0.3, 0.1, 0.6], [0.5, 0.2, 0.3]]),
    ...                   torch.tensor([2, 1]))
    >>> metric.compute()
    tensor([1., 0.])
    """

    def __init__(self, *, k: Optional[int] = None, device: DeviceLike = None) -> None:
        super().__init__(device=device)
        self.k = k
        self._add_buffer("scores", fill=0.0, axis=0)

    def update(self: THitRate, input, target) -> THitRate:
        """Score one batch of predictions against targets."""
        self._append(scores=hit_rate(self._input(input), self._input(target), k=self.k))
        return self

    def compute(self) -> torch.Tensor:
        """All per-example scores; an empty tensor before any update."""
        if self.num_samples == 0:
            return torch.zeros(0, device=self.device)
        return self._valid()[0].clone()
