"""BLEUScore class metric (counterpart of
``torcheval_tpu/metrics/text/bleu.py``). n-gram matching is host numpy;
the states are host float lengths (``input_len``, ``target_len``) and
float32 counter vectors on the device (``matches_by_order``,
``possible_matches_by_order``), all ``SUM``-merged."""

from __future__ import annotations

from typing import Optional, Sequence, TypeVar, Union

import torch

from torcheval_tpu_torch.metrics.functional.text.bleu import (
    _bleu_score_compute,
    _bleu_score_update,
)
from torcheval_tpu_torch.metrics.metric import MergeKind, Metric
from torcheval_tpu_torch.utils.convert import DeviceLike, narrow_64, to_torch

TBLEUScore = TypeVar("TBLEUScore", bound="BLEUScore")


class BLEUScore(Metric[torch.Tensor]):
    """BLEU score over all updates.

    Args:
        n_gram: maximum n-gram order, in {1, 2, 3, 4}.
        weights: per-order weights of length ``n_gram`` (uniform if
            ``None``).
        device: where the state lives (CUDA by default).

    >>> from torcheval_tpu_torch.metrics import BLEUScore
    >>> metric = BLEUScore(n_gram=4, device="cpu")
    >>> candidates = ["the squirrel is eating the nut", "the cat is on the mat"]
    >>> references = [["a squirrel is eating a nut", "the squirrel is eating a tasty nut"],
    ...               ["there is a cat on the mat", "a cat is on the mat"]]
    >>> metric.update(candidates, references).compute()
    tensor(0.6534)
    """

    _extra_device_attrs = ("weights",)

    def __init__(
        self,
        *,
        n_gram: int,
        weights: Optional[torch.Tensor] = None,
        device: DeviceLike = None,
    ) -> None:
        super().__init__(device=device)
        if n_gram not in (1, 2, 3, 4):
            raise ValueError(f"n_gram should be 1, 2, 3, or 4, got {n_gram}.")
        if weights is not None and n_gram != len(weights):
            raise ValueError(
                "the length of weights should equal n_gram, got "
                f"len(weights)={len(weights)}, n_gram={n_gram}"
            )
        self.weights = (
            None if weights is None else narrow_64(to_torch(weights, device=self.device))
        )
        self.n_gram = n_gram
        self._add_state("input_len", 0.0, merge=MergeKind.SUM)
        self._add_state("target_len", 0.0, merge=MergeKind.SUM)
        self._add_state(
            "matches_by_order", torch.zeros(n_gram), merge=MergeKind.SUM
        )
        self._add_state(
            "possible_matches_by_order", torch.zeros(n_gram), merge=MergeKind.SUM
        )

    def update(
        self: TBLEUScore,
        input: Union[str, Sequence[str]],
        target: Sequence[Union[str, Sequence[str]]],
    ) -> TBLEUScore:
        """Accumulate one batch of translations and their references."""
        input_len, target_len, matches, possible = _bleu_score_update(
            input, target, self.n_gram
        )
        self.input_len += input_len
        self.target_len += target_len
        self.matches_by_order = self.matches_by_order + self._input_float(matches)
        self.possible_matches_by_order = (
            self.possible_matches_by_order + self._input_float(possible)
        )
        return self

    def compute(self) -> torch.Tensor:
        """Running BLEU score; 0.0 before any match."""
        if float(torch.sum(self.matches_by_order)) == 0.0:
            return torch.zeros((), dtype=torch.float32, device=self.device)
        return _bleu_score_compute(
            self.input_len,
            self.target_len,
            self.matches_by_order,
            self.possible_matches_by_order,
            self.n_gram,
            self.weights,
            device=self.device,
        )
