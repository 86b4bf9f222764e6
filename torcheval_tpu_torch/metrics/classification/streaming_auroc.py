"""Streaming (histogram-state) binary AUROC and AUPRC.

Counterpart of ``torcheval_tpu/metrics/classification/streaming_auroc.py``.
The whole state is a fixed (num_tasks, 2, num_bins) float32 weight
histogram over bin edges fixed at construction (``bounds``), SUM-merged,
so state size and sync cost do not grow with the stream. ``update`` runs
one transform plan: on CUDA the Hopper kernel adds the batch straight into
``hist`` in place (``ops/csrc/fused_auc_hist.cu``); on the CPU the plain
version computes ``hist + histogram(batch)``.
"""

from __future__ import annotations

from typing import Tuple, TypeVar

import torch

from torcheval_tpu_torch.metrics.functional.classification.auroc import (
    _binary_auroc_update_input_check,
)
from torcheval_tpu_torch.metrics.metric import MergeKind, Metric, UpdatePlan
from torcheval_tpu_torch.ops.fused_auc import (
    DEFAULT_NUM_BINS,
    _auc_from_hist,
    _auprc_from_hist,
    histogram_accumulate_kernel,
)
from torcheval_tpu_torch.utils.convert import DeviceLike

TStreamingBinaryAUROC = TypeVar(
    "TStreamingBinaryAUROC", bound="StreamingBinaryAUROC"
)


class StreamingBinaryAUROC(Metric[torch.Tensor]):
    """Approximate binary AUROC with O(num_bins) mergeable state.

    Args:
        num_tasks: number of independent tasks.
        num_bins: histogram resolution; AUC error is O(1/num_bins).
        bounds: global (lo, hi) score range defining the bin edges.
        device: where the state lives (CUDA by default).

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import StreamingBinaryAUROC
    >>> metric = StreamingBinaryAUROC(device="cpu")
    >>> _ = metric.update(torch.tensor([0.1, 0.5, 0.7, 0.8]), torch.tensor([0, 0, 1, 1]))
    >>> metric.compute()
    tensor(1.)
    """

    def __init__(
        self,
        *,
        num_tasks: int = 1,
        num_bins: int = DEFAULT_NUM_BINS,
        bounds: Tuple[float, float] = (0.0, 1.0),
        device: DeviceLike = None,
    ) -> None:
        super().__init__(device=device)
        if num_tasks < 1:
            raise ValueError(
                "`num_tasks` value should be greater than and equal to 1, "
                f"but received {num_tasks}. "
            )
        if num_bins < 2:
            raise ValueError(f"num_bins must be >= 2, got {num_bins}.")
        lo, hi = float(bounds[0]), float(bounds[1])
        if not hi > lo:
            raise ValueError(f"bounds must satisfy hi > lo, got ({lo}, {hi}).")
        self.num_tasks = num_tasks
        self.num_bins = num_bins
        self.bounds = (lo, hi)
        self._add_state(
            "hist",
            torch.zeros((num_tasks, 2, num_bins), dtype=torch.float32),
            merge=MergeKind.SUM,
        )

    def merge_state(self: TStreamingBinaryAUROC, metrics) -> TStreamingBinaryAUROC:
        """SUM-merge histograms; peers must share the bin geometry (a
        ``bounds`` mismatch would silently add histograms with different
        bin edges, so it raises here)."""
        metrics = list(metrics)
        for other in metrics:
            if getattr(other, "bounds", None) != self.bounds:
                raise ValueError(
                    f"cannot merge {type(self).__name__} with different "
                    f"bounds: {self.bounds} vs {getattr(other, 'bounds', None)}"
                )
        return super().merge_state(metrics)

    def update(
        self: TStreamingBinaryAUROC, input, target, weight=None
    ) -> TStreamingBinaryAUROC:
        """Bin one batch of scores (n,) or (num_tasks, n) into the state,
        with binary labels and optional weights of the same shape."""
        return self._apply_update_plan(self._update_plan(input, target, weight))

    def _update_plan(self, input, target, weight=None):
        input, target = self._input_float(input), self._input(target)
        if weight is not None:
            weight = self._input_float(weight)
        _binary_auroc_update_input_check(input, target, self.num_tasks, weight)
        return UpdatePlan(
            histogram_accumulate_kernel,
            ("hist",),
            (input, target, weight),
            (self.num_bins, self.bounds),
            transform=True,
        )

    def compute(self) -> torch.Tensor:
        """AUROC from the histogram; scalar for ``num_tasks == 1``."""
        auc = _auc_from_hist(self.hist)
        return auc[0] if self.num_tasks == 1 else auc


class StreamingBinaryAUPRC(StreamingBinaryAUROC):
    """Approximate binary AUPRC with O(num_bins) mergeable state: the
    same histogram state and update as ``StreamingBinaryAUROC``, reduced
    to average precision (descending-threshold Riemann sum, each bin one
    tie group).

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import StreamingBinaryAUPRC
    >>> metric = StreamingBinaryAUPRC(device="cpu")
    >>> _ = metric.update(torch.tensor([0.1, 0.5, 0.7, 0.8]), torch.tensor([0, 0, 1, 1]))
    >>> metric.compute()
    tensor(1.)
    """

    def compute(self) -> torch.Tensor:
        """AUPRC from the histogram; scalar for ``num_tasks == 1``."""
        auprc = _auprc_from_hist(self.hist)
        return auprc[0] if self.num_tasks == 1 else auprc
