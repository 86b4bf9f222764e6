"""WindowedBinaryNormalizedEntropy (counterpart of
``torcheval_tpu/metrics/window/normalized_entropy.py``): three counters,
the lifetime trio and the concatenating merge, all from
``WindowedTaskCounterMetric``."""

from __future__ import annotations

from typing import Optional, Tuple, TypeVar, Union

import torch

from torcheval_tpu_torch.metrics.functional.classification.binary_normalized_entropy import (
    _baseline_update,
    _ne_input_check,
    _ne_update,
)
from torcheval_tpu_torch.metrics.window._base import WindowedTaskCounterMetric
from torcheval_tpu_torch.utils.convert import DeviceLike, narrow_64

TWindowedNormalizedEntropy = TypeVar(
    "TWindowedNormalizedEntropy", bound="WindowedBinaryNormalizedEntropy"
)


def _ne_window_kernel(input, target, weight, from_logits):
    """The NE kernel with its counters in this class's order
    ``(total_entropy, num_examples, num_positive)``."""
    ce, num_positive, num_examples = _ne_update(input, target, weight, from_logits)
    return ce, num_examples, num_positive


class WindowedBinaryNormalizedEntropy(WindowedTaskCounterMetric):
    """Normalized entropy over the last ``max_num_updates`` updates;
    ``compute()`` returns ``(lifetime, windowed)`` when
    ``enable_lifetime=True``, else the windowed value.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import WindowedBinaryNormalizedEntropy
    >>> metric = WindowedBinaryNormalizedEntropy(max_num_updates=2, device="cpu")
    >>> _ = metric.update(torch.tensor([0.2, 0.3]), torch.tensor([1.0, 0.0]))
    >>> _ = metric.update(torch.tensor([0.5, 0.6]), torch.tensor([1.0, 1.0]))
    >>> _ = metric.update(torch.tensor([0.6, 0.2]), torch.tensor([0.0, 1.0]))
    >>> metric.compute()
    (tensor([1.4914]), tensor([1.6581]))
    """

    def __init__(
        self,
        *,
        from_logits: bool = False,
        num_tasks: int = 1,
        max_num_updates: int = 100,
        enable_lifetime: bool = True,
        device: DeviceLike = None,
    ) -> None:
        super().__init__(device=device)
        self.from_logits = from_logits
        self._init_window_states(
            ("total_entropy", "num_examples", "num_positive"),
            num_tasks=num_tasks,
            max_num_updates=max_num_updates,
            enable_lifetime=enable_lifetime,
        )

    def update(
        self: TWindowedNormalizedEntropy, input, target, *, weight=None
    ) -> TWindowedNormalizedEntropy:
        """Write one batch's entropy counters into the window."""
        return self._apply_update_plan(self._update_plan(input, target, weight=weight))

    def _update_plan(self, input, target, *, weight=None):
        input = narrow_64(self._input(input))
        target = narrow_64(self._input(target))
        weight = None if weight is None else narrow_64(self._input(weight))
        _ne_input_check(input, target, self.from_logits, self.num_tasks, weight)
        return self._window_plan(
            _ne_window_kernel, (input, target, weight), config=(self.from_logits,)
        )

    def compute(self) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """Windowed (and lifetime) NE per task; empty before any update."""
        if self.total_updates == 0:
            return self._empty_result()
        entropy_sum, examples_sum, positive_sum = self._windowed_counter_sums()
        windowed = (entropy_sum / examples_sum) / _baseline_update(
            positive_sum, examples_sum
        )
        if self.enable_lifetime:
            lifetime = (self.total_entropy / self.num_examples) / _baseline_update(
                self.num_positive, self.num_examples
            )
            return lifetime, windowed
        return windowed
