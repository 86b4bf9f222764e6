"""WordInformationPreserved class metric (counterpart of
``torcheval_tpu/metrics/text/word_information_preserved.py``): host float
counters ``correct_total``, ``input_total`` and ``target_total``,
``SUM``-merged."""

from __future__ import annotations

from typing import List, TypeVar, Union

import torch

from torcheval_tpu_torch.metrics.functional.text.word_information_preserved import (
    _word_information_preserved_compute,
    _word_information_preserved_update,
)
from torcheval_tpu_torch.metrics.metric import MergeKind, Metric
from torcheval_tpu_torch.utils.convert import DeviceLike

TWordInformationPreserved = TypeVar(
    "TWordInformationPreserved", bound="WordInformationPreserved"
)


class WordInformationPreserved(Metric[torch.Tensor]):
    """Word information preserved over all updates (1 is perfect).

    >>> from torcheval_tpu_torch.metrics import WordInformationPreserved
    >>> metric = WordInformationPreserved(device="cpu")
    >>> metric.update(["hello world", "welcome to the facebook"],
    ...               ["hello metaverse", "welcome to meta"]).compute()
    tensor(0.3000)
    """

    def __init__(self, *, device: DeviceLike = None) -> None:
        super().__init__(device=device)
        self._add_state("correct_total", 0.0, merge=MergeKind.SUM)
        self._add_state("input_total", 0.0, merge=MergeKind.SUM)
        self._add_state("target_total", 0.0, merge=MergeKind.SUM)

    def update(
        self: TWordInformationPreserved,
        input: Union[str, List[str]],
        target: Union[str, List[str]],
    ) -> TWordInformationPreserved:
        """Accumulate one batch of sentence pairs."""
        correct, target_total, input_total = _word_information_preserved_update(
            input, target
        )
        self.correct_total += correct
        self.target_total += target_total
        self.input_total += input_total
        return self

    def compute(self) -> torch.Tensor:
        return _word_information_preserved_compute(
            self.correct_total, self.target_total, self.input_total, self.device
        )
