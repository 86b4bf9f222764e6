"""Binary normalized entropy class metric (counterpart of
``torcheval_tpu/metrics/classification/binary_normalized_entropy.py``):
per-task float32 counters ``total_entropy``, ``num_examples`` and
``num_positive``, all ``SUM``-merged."""

from __future__ import annotations

from typing import TypeVar

import torch

from torcheval_tpu_torch.metrics.functional.classification.binary_normalized_entropy import (
    _baseline_update,
    _ne_deltas,
    _ne_input_check,
)
from torcheval_tpu_torch.metrics.metric import MergeKind, Metric
from torcheval_tpu_torch.utils.convert import DeviceLike, narrow_64

TNormalizedEntropy = TypeVar("TNormalizedEntropy", bound="BinaryNormalizedEntropy")


class BinaryNormalizedEntropy(Metric[torch.Tensor]):
    """Normalized entropy (cross entropy / baseline entropy), optionally
    multi-task and weighted.

    Args:
        from_logits: ``input`` holds logits rather than probabilities.
        num_tasks: number of tasks; inputs are ``(num_tasks, n)`` when > 1.
        device: where the state lives (CUDA by default).

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import BinaryNormalizedEntropy
    >>> metric = BinaryNormalizedEntropy(device="cpu")
    >>> _ = metric.update(torch.tensor([0.2, 0.3]), torch.tensor([1.0, 0.0]))
    >>> metric.compute()
    tensor([1.4183])
    """

    def __init__(
        self,
        *,
        from_logits: bool = False,
        num_tasks: int = 1,
        device: DeviceLike = None,
    ) -> None:
        super().__init__(device=device)
        if num_tasks < 1:
            raise ValueError(
                "`num_tasks` value should be greater than and equal to 1, "
                f"but received {num_tasks}. "
            )
        self.from_logits = from_logits
        self.num_tasks = num_tasks
        self._add_state("total_entropy", torch.zeros(num_tasks), merge=MergeKind.SUM)
        self._add_state("num_examples", torch.zeros(num_tasks), merge=MergeKind.SUM)
        self._add_state("num_positive", torch.zeros(num_tasks), merge=MergeKind.SUM)

    def _update_plan(self, input, target, *, weight=None):
        input = narrow_64(self._input(input))
        target = narrow_64(self._input(target))
        weight = None if weight is None else narrow_64(self._input(weight))
        _ne_input_check(input, target, self.from_logits, self.num_tasks, weight)
        return (
            _ne_deltas,
            ("total_entropy", "num_positive", "num_examples"),
            (input, target, weight),
            (self.from_logits,),
        )

    def update(
        self: TNormalizedEntropy, input, target, *, weight=None
    ) -> TNormalizedEntropy:
        return self._apply_update_plan(self._update_plan(input, target, weight=weight))

    def compute(self) -> torch.Tensor:
        baseline = _baseline_update(self.num_positive, self.num_examples)
        return (self.total_entropy / self.num_examples) / baseline
