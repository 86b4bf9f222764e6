"""WeightedCalibration class metric (counterpart of
``torcheval_tpu/metrics/ranking/weighted_calibration.py``): per-task
float32 ``weighted_input_sum`` and ``weighted_target_sum``,
``SUM``-merged.

Besides the dense update (``(num_tasks, n)`` inputs), ``update(input,
target, weight, task_ids=...)`` takes a stream of per-event rows, each
with its task id: one segment sum a counter, ids outside
``[0, num_tasks)`` dropped (``ops.segment.safe_ids``). Sharding over the
task axis (``shard=``) is not ported yet.
"""

from __future__ import annotations

from typing import Tuple, TypeVar, Union

import torch

from torcheval_tpu_torch.metrics.classification.confusion_matrix import _no_shard
from torcheval_tpu_torch.metrics.functional.ranking.weighted_calibration import (
    _wc_update_scalar,
    _wc_update_tensor,
    _weighted_calibration_input_check,
)
from torcheval_tpu_torch.metrics.metric import MergeKind, Metric, UpdatePlan
from torcheval_tpu_torch.ops import segment
from torcheval_tpu_torch.utils.convert import DeviceLike, narrow_64, resolve_weight

TWeightedCalibration = TypeVar("TWeightedCalibration", bound="WeightedCalibration")


def _wc_scatter_rows(
    input: torch.Tensor,
    target: torch.Tensor,
    weight: torch.Tensor,
    task_ids: torch.Tensor,
    num_tasks: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense per-task deltas of a row stream: ``w * input`` and
    ``w * target`` summed by task id, out-of-range ids dropped."""
    w = weight.to(torch.float32).expand(input.shape)
    ids = segment.safe_ids(task_ids, num_tasks)
    return (
        segment.segment_sum(w * input.to(torch.float32), ids, num_tasks),
        segment.segment_sum(w * target.to(torch.float32), ids, num_tasks),
    )


class WeightedCalibration(Metric[torch.Tensor]):
    """``sum(weight * input) / sum(weight * target)``, optionally
    multi-task.

    Args:
        num_tasks: number of tasks.
        device: where the state lives (CUDA by default).
        shard: only ``None`` (sharded state is not ported yet).

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import WeightedCalibration
    >>> metric = WeightedCalibration(device="cpu")
    >>> _ = metric.update(torch.tensor([0.8, 0.4, 0.3, 0.8, 0.7, 0.6]),
    ...                   torch.tensor([1, 1, 0, 0, 1, 0]))
    >>> metric.compute()
    tensor([1.2000])
    """

    def __init__(
        self,
        *,
        num_tasks: int = 1,
        device: DeviceLike = None,
        shard=None,
    ) -> None:
        _no_shard(shard, "WeightedCalibration")
        super().__init__(device=device)
        if num_tasks < 1:
            raise ValueError(
                "`num_tasks` value should be greater than and equal to 1, "
                f"but received {num_tasks}. "
            )
        self.num_tasks = num_tasks
        self._add_state("weighted_input_sum", torch.zeros(num_tasks), merge=MergeKind.SUM)
        self._add_state("weighted_target_sum", torch.zeros(num_tasks), merge=MergeKind.SUM)

    def _update_plan(
        self,
        input,
        target,
        weight: Union[float, int, torch.Tensor] = 1.0,
        *,
        task_ids=None,
    ):
        input = narrow_64(self._input_float(input))
        target = narrow_64(self._input_float(target))
        if not isinstance(weight, (float, int)):
            weight = narrow_64(self._input_float(weight))
        if task_ids is not None:
            return self._rows_plan(input, target, weight, task_ids)
        _weighted_calibration_input_check(input, target, weight, self.num_tasks)
        is_scalar, weight_t = resolve_weight(weight, input)
        return (
            _wc_update_scalar if is_scalar else _wc_update_tensor,
            ("weighted_input_sum", "weighted_target_sum"),
            (input, target, weight_t),
        )

    def _rows_plan(self, input, target, weight, task_ids) -> UpdatePlan:
        """The per-event row form: ``input``, ``target`` and ``task_ids``
        are row-aligned vectors; ``weight`` a number or one a row."""
        task_ids = self._input(task_ids)
        if input.ndim != 1 or input.shape != target.shape:
            raise ValueError(
                "row updates (task_ids=...) expect one-dimensional "
                f"`input`/`target` of equal length, got shapes "
                f"{tuple(input.shape)} and {tuple(target.shape)}"
            )
        if task_ids.shape != input.shape:
            raise ValueError(
                f"`task_ids` shape ({tuple(task_ids.shape)}) must match "
                f"`input` shape ({tuple(input.shape)})"
            )
        if isinstance(weight, (float, int)):
            weight = torch.full((), float(weight), dtype=torch.float32, device=self.device)
        elif weight.shape != input.shape:
            raise ValueError(
                "Weight must be either a float value or a tensor that "
                f"matches the input tensor size. Got {weight} instead."
            )
        return UpdatePlan(
            _wc_scatter_rows,
            ("weighted_input_sum", "weighted_target_sum"),
            (input, target, weight, task_ids),
            (self.num_tasks,),
        )

    def update(
        self: TWeightedCalibration,
        input,
        target,
        weight: Union[float, int, torch.Tensor] = 1.0,
        *,
        task_ids=None,
    ) -> TWeightedCalibration:
        """Accumulate one batch of predictions, binary targets and weights
        (or per-event rows with ``task_ids=``)."""
        return self._apply_update_plan(
            self._update_plan(input, target, weight, task_ids=task_ids)
        )

    def compute(self) -> torch.Tensor:
        """Calibration per task; an empty tensor if any task has a zero
        target sum (one device-to-host read)."""
        if bool(torch.any(self.weighted_target_sum == 0.0)):
            return torch.zeros(0, device=self.device)
        return self.weighted_input_sum / self.weighted_target_sum
