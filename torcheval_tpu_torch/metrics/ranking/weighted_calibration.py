"""WeightedCalibration class metric (counterpart of
``torcheval_tpu/metrics/ranking/weighted_calibration.py``): per-task
float32 ``weighted_input_sum`` and ``weighted_target_sum``,
``SUM``-merged.

Besides the dense update (``(num_tasks, n)`` inputs), ``update(input,
target, weight, task_ids=...)`` takes a stream of per-event rows, each
with its task id: one segment sum a counter, ids outside
``[0, num_tasks)`` dropped (``ops.segment.safe_ids``); under shape
bucketing its plan pads the row axis and its twin sends padded rows to
the dropped id.

``WeightedCalibration(num_tasks=T, shard=ShardContext(rank, world))``
keeps ``T/world`` task rows a rank. Row updates route through the float
outbox lane (``shardspec.enable_value_routing``): owned rows are summed
into the local rows, foreign rows ship ``(task, w*x, w*t)`` with one
boundary a batch, so the reassembling merge adds in the replicated
metric's order and equals it bitwise. Dense ``(T, n)`` updates on a
sharded instance are owner-partitioned instead: every rank sees the same
stream and keeps its rows.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple, TypeVar, Union

import torch

from torcheval_tpu_torch.metrics.functional.ranking.weighted_calibration import (
    _wc_update_scalar,
    _wc_update_tensor,
    _weighted_calibration_input_check,
)
from torcheval_tpu_torch.metrics import shardspec
from torcheval_tpu_torch.metrics.metric import MergeKind, Metric, UpdatePlan
from torcheval_tpu_torch.metrics.shardspec import ShardSpec
from torcheval_tpu_torch.ops import segment
from torcheval_tpu_torch.utils.convert import DeviceLike, narrow_64, resolve_weight

TWeightedCalibration = TypeVar("TWeightedCalibration", bound="WeightedCalibration")


def _wc_route_rows(input, target, weight, task_ids):
    """A row stream as (task ids, (w*x, w*t)): the ``row_fn`` of the float
    outbox lane."""
    w = weight.to(torch.float32).expand(input.shape)
    return (
        task_ids.to(torch.int32),
        (w * input.to(torch.float32), w * target.to(torch.float32)),
    )


# owner-partitioned (row-sliced) twins of the dense kernels, one stable
# object a (kernel, range)
_SLICED_KERNEL_CACHE: Dict[Any, Any] = {}


def _sliced_kernel(kernel, start: int, stop: int):
    key = (kernel, int(start), int(stop))
    fn = _SLICED_KERNEL_CACHE.get(key)
    if fn is None:

        def fn(*args):
            return tuple(d if d.ndim == 0 else d[start:stop] for d in kernel(*args))

        _SLICED_KERNEL_CACHE[key] = fn
    return fn


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


def _wc_scatter_rows_masked(
    input: torch.Tensor,
    target: torch.Tensor,
    weight: torch.Tensor,
    task_ids: torch.Tensor,
    valid: torch.Tensor,
    num_tasks: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shape-bucketing twin of ``_wc_scatter_rows``: padded rows take the
    ``-1`` id, which every segment sum drops."""
    row_ok = torch.arange(task_ids.shape[0], device=task_ids.device) < valid[0]
    ids = torch.where(row_ok, task_ids, torch.full_like(task_ids, -1))
    return _wc_scatter_rows(input, target, weight, ids, num_tasks)


class WeightedCalibration(Metric[torch.Tensor]):
    """``sum(weight * input) / sum(weight * target)``, optionally
    multi-task.

    Args:
        num_tasks: number of tasks.
        device: where the state lives (CUDA by default).
        shard: a ``ShardContext`` partitioning the task axis (see the
            module docstring).

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
        super().__init__(device=device, shard=shard)
        if num_tasks < 1:
            raise ValueError(
                "`num_tasks` value should be greater than and equal to 1, "
                f"but received {num_tasks}. "
            )
        self.num_tasks = num_tasks
        spec = ShardSpec(axis=0) if shard is not None else None
        for name in ("weighted_input_sum", "weighted_target_sum"):
            self._add_state(name, torch.zeros(num_tasks), merge=MergeKind.SUM, shard=spec)
        if self._sharded_states:
            shardspec.enable_value_routing(self, ("weighted_input_sum", "weighted_target_sum"))

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
        kernel = _wc_update_scalar if is_scalar else _wc_update_tensor
        if self._sharded_states and self._own_shard_active():
            # owner-partitioned: every rank sees the stream, keeps its rows
            kernel = _sliced_kernel(kernel, *self._shard_ctx.shard_range(self.num_tasks))
        return (
            kernel,
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
        is_scalar = isinstance(weight, (float, int))
        if is_scalar:
            weight = torch.full((), float(weight), dtype=torch.float32, device=self.device)
        elif weight.shape != input.shape:
            raise ValueError(
                "Weight must be either a float value or a tensor that "
                f"matches the input tensor size. Got {weight} instead."
            )
        axes = (("n",), ("n",), () if is_scalar else ("n",), ("n",))
        if self._route_active("weighted_input_sum"):
            return self._routed_rows_plan(input, target, weight, task_ids, axes)
        return UpdatePlan(
            _wc_scatter_rows,
            ("weighted_input_sum", "weighted_target_sum"),
            (input, target, weight, task_ids),
            (self.num_tasks,),
            masked_kernel=_wc_scatter_rows_masked,
            batch_axes=axes,
        )

    def _routed_rows_plan(self, input, target, weight, task_ids, axes) -> UpdatePlan:
        """The row form on a sharded instance: the float outbox lane."""
        names = self._routed_states["weighted_input_sum"]
        n = int(input.shape[0])
        shardspec.ensure_outbox_capacity(self, "weighted_input_sum", n)
        start, stop = self._shard_ctx.shard_range(self.num_tasks)
        obh, obbh = int(getattr(self, names.obh)), int(getattr(self, names.obbh))

        def finalize() -> None:
            setattr(self, names.obh, obh + n)
            setattr(self, names.obbh, obbh + 1)

        return UpdatePlan(
            shardspec.route_scatter_values_kernel(_wc_route_rows, start, stop, 2),
            (
                "weighted_input_sum",
                "weighted_target_sum",
                names.obi,
                names.obv,
                names.obn,
                names.obb,
                names.obc,
            ),
            (input, target, weight, task_ids),
            (),
            transform=True,
            finalize=finalize,
            masked_kernel=shardspec.route_scatter_values_kernel_masked(
                _wc_route_rows, start, stop, 2
            ),
            batch_axes=axes,
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
        target sum (one device-to-host read). A shard carrier computes over
        its local logical view (its rows plus its outbox); sync first for
        the global value."""
        target_sum = self._logical_state("weighted_target_sum")
        if bool(torch.any(target_sum == 0.0)):
            return torch.zeros(0, device=self.device)
        return self._logical_state("weighted_input_sum") / target_sum
