"""AUC class metric (counterpart of
``torcheval_tpu/metrics/aggregation/auc.py``): (x, y) points buffered in
growable (n_tasks, capacity) buffers, integrated by the trapezoidal rule
at compute."""

from __future__ import annotations

from typing import TypeVar

import torch

from torcheval_tpu_torch.metrics._buffer import BufferedExamplesMetric
from torcheval_tpu_torch.metrics.functional.aggregation.auc import (
    _auc_compute_masked,
    _auc_update_input_check,
)
from torcheval_tpu_torch.utils.convert import DeviceLike

TAUC = TypeVar("TAUC", bound="AUC")


class AUC(BufferedExamplesMetric):
    """Trapezoidal AUC of arbitrary (x, y) curves, buffered across updates.

    Args:
        reorder: stably sort the buffered x before integrating (default
            True, the reference class's default).
        n_tasks: number of independent curves per update.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import AUC
    >>> metric = AUC(device="cpu")
    >>> metric.update(torch.tensor([0., .5, 1.]), torch.tensor([1., .5, 0.])).compute()
    tensor([0.5000])
    """

    def __init__(
        self, *, reorder: bool = True, n_tasks: int = 1, device: DeviceLike = None
    ) -> None:
        super().__init__(device=device)
        self.reorder = reorder
        self.n_tasks = n_tasks
        # the pad fill is never read: the compute clamps pads to the last
        # valid point (zero-width trapezoids)
        self._add_buffer("x", fill=0.0, axis=-1)
        self._add_buffer("y", fill=0.0, axis=-1)

    def update(self: TAUC, x, y) -> TAUC:
        x, y = self._input(x), self._input(y)
        _auc_update_input_check(x, y, self.n_tasks)
        BufferedExamplesMetric._append(self, x=torch.atleast_2d(x), y=torch.atleast_2d(y))
        return self

    def compute(self) -> torch.Tensor:
        if self.num_samples == 0:
            return torch.zeros((0,), device=self.device)
        x, y = self._padded()
        return _auc_compute_masked(x, y, self.num_samples, self.reorder)
