"""Confusion matrix class metrics (counterpart of
``torcheval_tpu/metrics/classification/confusion_matrix.py``): one
``(C, C)`` int32 counter state with ``SUM`` merge, so merged and synced
matrices are exact. ``MulticlassConfusionMatrix(shard=ShardContext(rank,
world))`` keeps this rank's ``C/world`` true-class rows and routes the
other cells through an outbox (``metrics/shardspec.py``)."""

from __future__ import annotations

from typing import Optional, TypeVar

import torch

from torcheval_tpu_torch.metrics.functional.classification.confusion_matrix import (
    _binary_confusion_matrix_update_input_check,
    _binary_confusion_matrix_update_jit,
    _binary_confusion_matrix_update_masked,
    _confusion_matrix_compute,
    _confusion_matrix_flat_index,
    _confusion_matrix_param_check,
    _confusion_matrix_update_input_check,
    _confusion_matrix_update_jit,
    _confusion_matrix_update_masked,
)
from torcheval_tpu_torch.metrics import shardspec
from torcheval_tpu_torch.metrics.metric import MergeKind, Metric, UpdatePlan
from torcheval_tpu_torch.metrics.shardspec import ShardSpec
from torcheval_tpu_torch.utils.convert import DeviceLike

TMulticlassConfusionMatrix = TypeVar(
    "TMulticlassConfusionMatrix", bound="MulticlassConfusionMatrix"
)


class MulticlassConfusionMatrix(Metric[torch.Tensor]):
    """Multiclass confusion matrix; entry (i, j) counts true class i
    predicted as class j.

    Args:
        num_classes: C, at least 2.
        normalize: ``None``/``"none"``, ``"pred"``, ``"true"`` or ``"all"``.
        device: where the state lives (CUDA by default).
        shard: a ``ShardContext``: the matrix is partitioned by true-class
            rows over the shard world, owned cells are counted in place and
            the rest go to an outbox, and a sync ships ``shard + outbox``.
            Counts are int32, so sharded results equal the replicated ones
            bitwise.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import MulticlassConfusionMatrix
    >>> metric = MulticlassConfusionMatrix(3, device="cpu")
    >>> _ = metric.update(torch.tensor([0, 2, 1, 1]), torch.tensor([0, 1, 2, 1]))
    >>> metric.compute()
    tensor([[1, 0, 0],
            [0, 1, 1],
            [0, 1, 0]], dtype=torch.int32)
    """

    def __init__(
        self,
        num_classes: int,
        *,
        normalize: Optional[str] = None,
        device: DeviceLike = None,
        shard=None,
    ) -> None:
        super().__init__(device=device, shard=shard)
        _confusion_matrix_param_check(num_classes, normalize)
        self.num_classes = num_classes
        self.normalize = normalize
        self._add_state(
            "confusion_matrix",
            torch.zeros((num_classes, num_classes), dtype=torch.int32),
            merge=MergeKind.SUM,
            shard=ShardSpec(axis=0),
        )
        shardspec.enable_routing(self, "confusion_matrix")

    def _update_plan(self, input, target):
        input, target = self._input(input), self._input(target)
        _confusion_matrix_update_input_check(input, target, self.num_classes)
        if self._route_active("confusion_matrix"):
            return self._sharded_update_plan(input, target)
        # replicated instances, world-1 shards and logical (merged)
        # instances count densely, with the masked twin
        return UpdatePlan(
            _confusion_matrix_update_jit,
            ("confusion_matrix",),
            (input, target),
            (self.num_classes,),
            masked_kernel=_confusion_matrix_update_masked,
            batch_axes=(("batch",), ("batch",)),
        )

    def _sharded_update_plan(self, input, target) -> UpdatePlan:
        """The routed plan: flat cell index, owned cells into the local
        rows, foreign cells into the outbox (``shardspec.
        route_scatter_kernel``), with its masked twin for bucketing."""
        name = "confusion_matrix"
        names = self._routed_states[name]
        n = int(target.shape[0])
        shardspec.ensure_outbox_capacity(self, name, n)
        start, stop = self._shard_ctx.shard_range(self.num_classes)
        flat_args = (
            _confusion_matrix_flat_index,
            start * self.num_classes,
            stop * self.num_classes,
            (self.num_classes,),
        )

        def finalize():
            setattr(self, names.obh, getattr(self, names.obh) + n)

        return UpdatePlan(
            shardspec.route_scatter_kernel(*flat_args),
            (name, names.obi, names.obn),
            (input, target),
            (),
            transform=True,
            finalize=finalize,
            masked_kernel=shardspec.route_scatter_kernel_masked(*flat_args),
            batch_axes=(("batch",), ("batch",)),
        )

    def update(self: TMulticlassConfusionMatrix, input, target) -> TMulticlassConfusionMatrix:
        return self._apply_update_plan(self._update_plan(input, target))

    def compute(self) -> torch.Tensor:
        # a shard carrier computes over its local logical view (its rows
        # plus its outbox): a replicated metric's local value
        return _confusion_matrix_compute(self._logical_state("confusion_matrix"), self.normalize)

    def normalized(self, normalize: Optional[str] = None) -> torch.Tensor:
        """The matrix under another normalization."""
        _confusion_matrix_param_check(self.num_classes, normalize)
        return _confusion_matrix_compute(self._logical_state("confusion_matrix"), normalize)


class BinaryConfusionMatrix(MulticlassConfusionMatrix):
    """2x2 confusion matrix of scores binarized at ``threshold``.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import BinaryConfusionMatrix
    >>> metric = BinaryConfusionMatrix(device="cpu")
    >>> _ = metric.update(torch.tensor([0.2, 0.8, 0.6, 0.3]), torch.tensor([0, 1, 1, 0]))
    >>> metric.compute()
    tensor([[2, 0],
            [0, 2]], dtype=torch.int32)
    """

    def __init__(
        self,
        *,
        threshold: float = 0.5,
        normalize: Optional[str] = None,
        device: DeviceLike = None,
    ) -> None:
        super().__init__(num_classes=2, normalize=normalize, device=device)
        self.threshold = threshold

    def _update_plan(self, input, target):
        input, target = self._input(input), self._input(target)
        _binary_confusion_matrix_update_input_check(input, target)
        return UpdatePlan(
            _binary_confusion_matrix_update_jit,
            ("confusion_matrix",),
            (input, target),
            (float(self.threshold),),
            masked_kernel=_binary_confusion_matrix_update_masked,
            batch_axes=(("batch",), ("batch",)),
        )
