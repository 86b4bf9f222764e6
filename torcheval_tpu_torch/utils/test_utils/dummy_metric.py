"""Minimal metrics, one a state type, for base, toolkit and sync tests
(counterpart of ``torcheval_tpu/utils/test_utils/dummy_metric.py``): a
trivial sum over a tensor state, a list state and a dict state."""

from __future__ import annotations

import torch

from torcheval_tpu_torch.metrics.metric import MergeKind, Metric


class DummySumMetric(Metric[torch.Tensor]):
    """Sums scalar updates into a tensor state."""

    def __init__(self, *, device=None) -> None:
        super().__init__(device=device)
        self._add_state("sum", torch.zeros(()), merge=MergeKind.SUM)

    def update(self, x) -> "DummySumMetric":
        self.sum = self.sum + self._input_float(x)
        return self

    def compute(self) -> torch.Tensor:
        return self.sum


class DummySumListStateMetric(Metric[torch.Tensor]):
    """Buffers every update in a list state."""

    def __init__(self, *, device=None) -> None:
        super().__init__(device=device)
        self._add_state("x", [], merge=MergeKind.EXTEND)

    def update(self, x) -> "DummySumListStateMetric":
        self.x.append(self._input_float(x))
        return self

    def compute(self) -> torch.Tensor:
        return torch.as_tensor(sum(t.sum() for t in self.x))


class DummySumDictStateMetric(Metric[torch.Tensor]):
    """Keyed sums in a dict state; a key first updated starts from 0, as
    the JAX package's zero-default dict state does."""

    def __init__(self, *, device=None) -> None:
        super().__init__(device=device)
        self._add_state("x", {}, merge=MergeKind.SUM)

    def update(self, k: str, v) -> "DummySumDictStateMetric":
        v = self._input_float(v)
        self.x[k] = self.x[k] + v if k in self.x else torch.zeros_like(v) + v
        return self

    def compute(self):
        return self.x
