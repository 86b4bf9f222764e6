"""Perplexity class metric (counterpart of
``torcheval_tpu/metrics/text/perplexity.py``): a float32 ``sum_log_probs``
and an int32 ``num_total`` (an exact counter: a float32 one would stop
counting at 2^24 tokens), both ``SUM``-merged."""

from __future__ import annotations

from typing import Optional, TypeVar

import torch

from torcheval_tpu_torch.metrics.functional.text.perplexity import (
    _perplexity_compute,
    _perplexity_input_check,
    _perplexity_inputs,
    _perplexity_update_jit,
)
from torcheval_tpu_torch.metrics.metric import MergeKind, Metric, UpdatePlan
from torcheval_tpu_torch.utils.convert import DeviceLike

TPerplexity = TypeVar("TPerplexity", bound="Perplexity")


class Perplexity(Metric[torch.Tensor]):
    """Perplexity, ``exp(summed NLL / number of tokens)``, over all
    updates. A float16 or bfloat16 batch's sum is added into the float32
    state.

    Args:
        ignore_index: target tokens with this value are left out.
        device: where the state lives (CUDA by default).

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import Perplexity
    >>> metric = Perplexity(device="cpu")
    >>> input = torch.tensor([[[0.3659, 0.7025, 0.3104], [0.0097, 0.6577, 0.1947]]])
    >>> metric.update(input, torch.tensor([[2, 1]])).compute()
    tensor(2.7593)
    """

    def __init__(
        self, *, ignore_index: Optional[int] = None, device: DeviceLike = None
    ) -> None:
        super().__init__(device=device)
        self.ignore_index = ignore_index
        self._add_state("sum_log_probs", torch.zeros(()), merge=MergeKind.SUM)
        self._add_state(
            "num_total", torch.zeros((), dtype=torch.int32), merge=MergeKind.SUM
        )

    def _update_plan(self, input, target):
        input, target = _perplexity_inputs(
            self._input_float(input), self._input(target), self.device
        )
        _perplexity_input_check(input, target, self.ignore_index)
        return UpdatePlan(
            _perplexity_update_jit,
            ("sum_log_probs", "num_total"),
            (input, target),
            (self.ignore_index,),
        )

    def update(self: TPerplexity, input, target) -> TPerplexity:
        """Accumulate one batch: logits (n_samples, seq_len, vocab_size)
        and vocabulary indices (n_samples, seq_len)."""
        return self._apply_update_plan(self._update_plan(input, target))

    def compute(self) -> torch.Tensor:
        return _perplexity_compute(self.sum_log_probs, self.num_total)
