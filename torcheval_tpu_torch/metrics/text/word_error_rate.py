"""WordErrorRate class metric (counterpart of
``torcheval_tpu/metrics/text/word_error_rate.py``): host float counters
``errors`` and ``total``, ``SUM``-merged."""

from __future__ import annotations

from typing import List, TypeVar, Union

import torch

from torcheval_tpu_torch.metrics.functional.text.word_error_rate import (
    _word_error_rate_compute,
    _word_error_rate_update,
)
from torcheval_tpu_torch.metrics.metric import MergeKind, Metric
from torcheval_tpu_torch.utils.convert import DeviceLike

TWordErrorRate = TypeVar("TWordErrorRate", bound="WordErrorRate")


class WordErrorRate(Metric[torch.Tensor]):
    """Word error rate over all updates; NaN before any update.

    >>> from torcheval_tpu_torch.metrics import WordErrorRate
    >>> metric = WordErrorRate(device="cpu")
    >>> metric.update(["this is the prediction", "there is an other sample"],
    ...               ["this is the reference", "there is another one"]).compute()
    tensor(0.5000)
    """

    def __init__(self, *, device: DeviceLike = None) -> None:
        super().__init__(device=device)
        self._add_state("errors", 0.0, merge=MergeKind.SUM)
        self._add_state("total", 0.0, merge=MergeKind.SUM)

    def update(
        self: TWordErrorRate,
        input: Union[str, List[str]],
        target: Union[str, List[str]],
    ) -> TWordErrorRate:
        """Accumulate the edit distances of one batch of sentence pairs."""
        errors, total = _word_error_rate_update(input, target)
        self.errors += errors
        self.total += total
        return self

    def compute(self) -> torch.Tensor:
        return _word_error_rate_compute(self.errors, self.total, self.device)
