"""PeakSignalNoiseRatio class metric (counterpart of
``torcheval_tpu/metrics/image/psnr.py``): the sum of squared errors and
the observation count (SUM), and, with the auto range, the running
min/max of the target (MIN/MAX) with the derived ``data_range``
recomputed after a merge."""

from __future__ import annotations

from typing import Iterable, Optional, TypeVar

import torch

from torcheval_tpu_torch.metrics.functional.image.psnr import (
    _psnr_accumulate,
    _psnr_compute,
    _psnr_input_check,
    _psnr_param_check,
    _psnr_update,
)
from torcheval_tpu_torch.metrics.functional.tensor_utils import check_reducible
from torcheval_tpu_torch.metrics.metric import MergeKind, Metric, UpdatePlan
from torcheval_tpu_torch.utils.convert import DeviceLike, narrow_64

TPeakSignalNoiseRatio = TypeVar("TPeakSignalNoiseRatio", bound="PeakSignalNoiseRatio")


def _psnr_auto_transform(states, input, target):
    """The auto-range update as a transform plan: ``states`` are
    (sum_squared_error, num_observations, min_target, max_target,
    data_range); the first four advance and the fifth is derived."""
    return _psnr_accumulate(*states[:4], input, target)


class PeakSignalNoiseRatio(Metric[torch.Tensor]):
    """PSNR between the accumulated input and target images (functional
    version: ``peak_signal_noise_ratio``). ``data_range`` is the images'
    range; ``None`` uses the observed ``target.max() - target.min()`` over
    all updates.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import PeakSignalNoiseRatio
    >>> metric = PeakSignalNoiseRatio(device="cpu")
    >>> input = torch.tensor([[0.1, 0.2], [0.3, 0.4]])
    >>> metric.update(input, input * 0.9).compute()
    tensor(19.8767)
    """

    def __init__(self, data_range: Optional[float] = None, *, device: DeviceLike = None) -> None:
        super().__init__(device=device)
        _psnr_param_check(data_range=data_range)
        self.auto_range = data_range is None
        # derived from min/max when auto; the same on every replica when
        # fixed, where the MAX merge is the identity
        self._add_state(
            "data_range", torch.tensor(0.0 if self.auto_range else data_range),
            merge=MergeKind.MAX,
        )
        self._add_state("num_observations", torch.zeros(()), merge=MergeKind.SUM)
        self._add_state("sum_squared_error", torch.zeros(()), merge=MergeKind.SUM)
        self._add_state("min_target", torch.tensor(float("inf")), merge=MergeKind.MIN)
        self._add_state("max_target", torch.tensor(-float("inf")), merge=MergeKind.MAX)

    def update(self: TPeakSignalNoiseRatio, input, target) -> TPeakSignalNoiseRatio:
        """Accumulate one batch of image pairs, (N, C, H, W) each."""
        return self._apply_update_plan(self._update_plan(input, target))

    def _update_plan(self, input, target):
        input = narrow_64(self._input_float(input))
        target = narrow_64(self._input_float(target))
        _psnr_input_check(input, target)
        if self.auto_range:
            check_reducible(target, "min")
            return UpdatePlan(
                _psnr_auto_transform,
                ("sum_squared_error", "num_observations", "min_target", "max_target",
                 "data_range"),
                (input, target),
                transform=True,
            )
        return (_psnr_update, ("sum_squared_error", "num_observations"), (input, target), ())

    def merge_state(
        self: TPeakSignalNoiseRatio, metrics: Iterable[TPeakSignalNoiseRatio]
    ) -> TPeakSignalNoiseRatio:
        super().merge_state(metrics)
        if self.auto_range:
            self.data_range = self.max_target - self.min_target
        return self

    def compute(self) -> torch.Tensor:
        """The running PSNR."""
        return _psnr_compute(self.sum_squared_error, self.num_observations, self.data_range)
