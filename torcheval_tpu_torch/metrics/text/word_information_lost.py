"""WordInformationLost class metric (counterpart of
``torcheval_tpu/metrics/text/word_information_lost.py``): host float
counters ``correct_total``, ``target_total`` and ``preds_total``,
``SUM``-merged."""

from __future__ import annotations

from typing import List, TypeVar, Union

import torch

from torcheval_tpu_torch.metrics.functional.text.word_information_lost import (
    _wil_compute,
    _wil_update,
)
from torcheval_tpu_torch.metrics.metric import MergeKind, Metric
from torcheval_tpu_torch.utils.convert import DeviceLike

TWordInformationLost = TypeVar("TWordInformationLost", bound="WordInformationLost")


class WordInformationLost(Metric[torch.Tensor]):
    """Word information lost over all updates (0 is perfect).

    >>> from torcheval_tpu_torch.metrics import WordInformationLost
    >>> metric = WordInformationLost(device="cpu")
    >>> metric.update(["this is the prediction", "there is an other sample"],
    ...               ["this is the reference", "there is another one"]).compute()
    tensor(0.6528)
    """

    def __init__(self, *, device: DeviceLike = None) -> None:
        super().__init__(device=device)
        self._add_state("correct_total", 0.0, merge=MergeKind.SUM)
        self._add_state("target_total", 0.0, merge=MergeKind.SUM)
        self._add_state("preds_total", 0.0, merge=MergeKind.SUM)

    def update(
        self: TWordInformationLost,
        input: Union[str, List[str]],
        target: Union[str, List[str]],
    ) -> TWordInformationLost:
        """Accumulate one batch of sentence pairs."""
        correct_total, target_total, preds_total = _wil_update(input, target)
        self.correct_total += correct_total
        self.target_total += target_total
        self.preds_total += preds_total
        return self

    def compute(self) -> torch.Tensor:
        return _wil_compute(
            self.correct_total, self.target_total, self.preds_total, self.device
        )
