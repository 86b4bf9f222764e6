"""WindowedBinaryAUROC (counterpart of
``torcheval_tpu/metrics/window/auroc.py``).

Unlike the other windowed metrics this one windows over samples: raw
(input, target, weight) triples live in ``(num_tasks, max_num_samples)``
float32 rings. A batch smaller than the capacity lands at positions
``(cursor + j) % capacity``, one ``index_copy_`` that covers both the
fits-in-rest and the wrapping cases of the reference; a batch at least as
large as the capacity leaves its last ``capacity`` samples, written from
column 0. Merge packs the valid prefixes of every replica.
"""

from __future__ import annotations

from typing import Iterable, Optional, TypeVar

import torch

from torcheval_tpu_torch.metrics.functional.classification.auroc import (
    _binary_auroc_compute,
    _binary_auroc_update_input_check,
)
from torcheval_tpu_torch.metrics.metric import MergeKind, Metric, UpdatePlan
from torcheval_tpu_torch.metrics.window._base import RingCursorSerializationMixin
from torcheval_tpu_torch.utils.convert import DeviceLike

TWindowedBinaryAUROC = TypeVar("TWindowedBinaryAUROC", bound="WindowedBinaryAUROC")

_RINGS = ("inputs", "targets", "weights")


def _stack_batch(input, target, weight):
    """(tasks, n) views of a batch; no weight reads as all ones."""
    i2, t2 = torch.atleast_2d(input), torch.atleast_2d(target)
    w2 = torch.ones_like(i2) if weight is None else torch.atleast_2d(weight)
    return i2, t2, w2


def _ring_insert(rings, col, input, target, weight):
    """Write a batch of n < capacity samples at positions ``(col + j) %
    capacity``, in place: the batch's head on the ring's tail and its rest
    at the front when it wraps. n < capacity keeps the indices distinct.
    The capacity is the buffer's width, which a merge enlarges."""
    cap = rings[0].shape[1]
    vals = _stack_batch(input, target, weight)
    idx = (torch.arange(vals[0].shape[1], device=rings[0].device) + col) % cap
    for ring, v in zip(rings, vals):
        ring.index_copy_(1, idx, v.to(ring.dtype))
    return rings


def _ring_overwrite(rings, input, target, weight):
    """A batch of n >= ``max_num_samples``: its last ``capacity`` samples
    are written from column 0, in place (the reference's oversized case)."""
    cap = rings[0].shape[1]
    vals = _stack_batch(input, target, weight)
    for ring, v in zip(rings, vals):
        tail = v[:, -cap:]
        ring[:, : tail.shape[1]] = tail.to(ring.dtype)
    return rings


class WindowedBinaryAUROC(RingCursorSerializationMixin, Metric[torch.Tensor]):
    """AUROC over the last ``max_num_samples`` samples.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import WindowedBinaryAUROC
    >>> metric = WindowedBinaryAUROC(max_num_samples=4, device="cpu")
    >>> _ = metric.update(torch.tensor([0.2, 0.5, 0.1, 0.5, 0.7, 0.8]),
    ...                   torch.tensor([0, 1, 1, 0, 1, 1]))
    >>> metric.compute()
    tensor(0.6667)
    """

    _cursor_total_state = "total_samples"
    _cursor_capacity_state = "max_num_samples"

    def __init__(
        self,
        *,
        num_tasks: int = 1,
        max_num_samples: int = 100,
        device: DeviceLike = None,
    ) -> None:
        super().__init__(device=device)
        if num_tasks < 1:
            raise ValueError(
                "`num_tasks` value should be greater than and equal to 1, "
                f"but received {num_tasks}. "
            )
        if max_num_samples < 1:
            raise ValueError(
                "`max_num_samples` value should be greater than and equal to "
                f"1, but received {max_num_samples}. "
            )
        self.num_tasks = num_tasks
        self._add_state("max_num_samples", max_num_samples, merge=MergeKind.CUSTOM)
        self.next_inserted = 0
        self._add_state("total_samples", 0, merge=MergeKind.CUSTOM)
        for name in _RINGS:
            self._add_state(
                name, torch.zeros((num_tasks, max_num_samples)), merge=MergeKind.CUSTOM
            )

    def update(
        self: TWindowedBinaryAUROC, input, target, weight=None
    ) -> TWindowedBinaryAUROC:
        """Insert a batch of samples into the rings."""
        return self._apply_update_plan(self._update_plan(input, target, weight))

    def _update_plan(self, input, target, weight=None):
        input, target = self._input(input), self._input(target)
        if weight is not None:
            weight = self._input_float(weight)
        _binary_auroc_update_input_check(input, target, self.num_tasks, weight)
        n = input.shape[-1]
        cap = self.max_num_samples
        col = self.next_inserted
        if n >= cap:

            def finalize():
                self.next_inserted = 0
                self.total_samples += n

            return UpdatePlan(
                _ring_overwrite, _RINGS, (input, target, weight),
                transform=True, finalize=finalize,
            )

        def finalize():
            self.next_inserted = (col + n) % cap
            self.total_samples += n

        return UpdatePlan(
            _ring_insert, _RINGS, (col, input, target, weight),
            transform=True, finalize=finalize,
        )

    def _sync_state_dict(self):
        """Until the ring wraps, the filled region is the column prefix
        ``[0, total_samples)``: a sync ships that prefix, not the whole
        ``max_num_samples`` window. ``merge_state`` reads only the valid
        prefix of a peer and ``compute``'s partial-window probe sees an
        empty suffix, so trimmed and full snapshots merge alike. A wrapped
        ring ships whole."""
        sd = super()._sync_state_dict()
        filled = min(self.total_samples, self.max_num_samples)
        if filled < self.max_num_samples:
            for name in _RINGS:
                sd[name] = sd[name][:, :filled]
        return sd

    def compute(self) -> torch.Tensor:
        """AUROC per task over the windowed samples; empty before any
        update."""
        if self.total_samples == 0:
            return torch.zeros(0, device=self.device)
        # the reference's partial-window probe: an all-zero suffix past the
        # cursor reads as unfilled (a real zero score there is taken for
        # one, a quirk kept for parity)
        if bool(torch.all(self.inputs[:, self.next_inserted :] == 0)):
            inputs, targets, weights = (
                getattr(self, name)[:, : self.next_inserted] for name in _RINGS
            )
        else:
            inputs, targets, weights = self.inputs, self.targets, self.weights
        return _binary_auroc_compute(
            inputs.squeeze(), targets.squeeze(), weights.squeeze(), False
        )

    def merge_state(
        self: TWindowedBinaryAUROC, metrics: Iterable[TWindowedBinaryAUROC]
    ) -> TWindowedBinaryAUROC:
        """Pack every replica's valid samples into enlarged rings; the
        cursor is then ``samples packed % max_num_samples``."""
        metrics = list(metrics)
        merged_cols = self.max_num_samples + sum(m.max_num_samples for m in metrics)
        cur_size = min(self.total_samples, self.max_num_samples)
        new_bufs = {}
        for name in _RINGS:
            buf = torch.zeros((self.num_tasks, merged_cols), device=self.device)
            buf[:, :cur_size] = getattr(self, name)[:, :cur_size]
            new_bufs[name] = buf
        idx = cur_size
        for m in metrics:
            size = min(m.total_samples, m.max_num_samples)
            for name in _RINGS:
                theirs = self._place_state(getattr(m, name))
                new_bufs[name][:, idx : idx + size] = theirs[:, :size]
            idx += size
            self.total_samples += m.total_samples
        for name in _RINGS:
            setattr(self, name, new_bufs[name])
        self.next_inserted = idx % self.max_num_samples
        return self
