"""RetrievalPrecision class metric (counterpart of
``torcheval_tpu/metrics/ranking/retrieval_precision.py``): precision @ k
over one or more query streams.

State: for each query, the running top-k scores (``topk``) and their
labels (``target``), float32 tensors in two lists, ``MergeKind.CUSTOM``;
a merge concatenates each query's buffers and ``compute`` ranks them
again. An update keeps, per query, the top k of its buffer followed by
its new rows in their order in the batch, so ties (broken by the lower
index) resolve as in the JAX package.

Rows reach their queries through ``indexes``; as there, the indexes are
read on the host (one device-to-host copy an update) and indexes outside
``[0, num_queries)`` are ignored. Where the JAX package ranks one query
at a time, this ranks every query the batch touches in one ``topk`` over
a padded ``(queries, length)`` matrix: the padding's totalOrder key is the
lowest of any float32 (a NaN with every bit set), and it sits after every
real entry of its row, so no row keeps a pad while a real entry is left.
``compute`` ranks every query in one ``topk`` the same way and reads the
per-query "has a positive" flags in one host copy.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, TypeVar

import numpy as np
import torch

from torcheval_tpu_torch.metrics.functional.ranking.retrieval_precision import (
    _nb_retrieved,
    _precision,
    _retrieval_precision_param_check,
    _retrieval_precision_update_input_check,
)
from torcheval_tpu_torch.metrics.metric import MergeKind, Metric
from torcheval_tpu_torch.ops.topk import topk
from torcheval_tpu_torch.utils.convert import DeviceLike, narrow_64

TRetrievalPrecision = TypeVar("TRetrievalPrecision", bound="RetrievalPrecision")

# the value of a query with no positive label ("err" raises instead)
_EMPTY_TARGET_ACTIONS = {"neg": 0.0, "pos": 1.0, "skip": np.nan, "err": np.nan}


def _row_layout(lengths: np.ndarray, counts: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """(R, L) int64 positions into ``cat(buffer_0, ..., buffer_{R-1},
    batch)``: row ``j`` lists its buffer (``lengths[j]`` entries), then
    its ``counts[j]`` batch rows, taken in order from ``rows`` (grouped
    by row ``j``); -1 pads each row to the longest."""
    total = lengths + counts
    width = int(total.max()) if total.size else 0
    col = np.arange(width, dtype=np.int64)[None, :]
    own = lengths[:, None]
    buffer_pos = (np.cumsum(lengths) - lengths)[:, None] + col
    if rows.size:
        start = (np.cumsum(counts) - counts)[:, None]
        batch_pos = int(lengths.sum()) + rows[np.clip(start + col - own, 0, rows.size - 1)]
    else:
        batch_pos = np.zeros_like(buffer_pos)
    return np.where(col < own, buffer_pos, np.where(col < total[:, None], batch_pos, -1))


def _padded(layout: np.ndarray, values: List[torch.Tensor], targets: List[torch.Tensor]):
    """Scores and labels laid out by ``_row_layout``: pads hold the
    lowest-keyed NaN and label 0."""
    src_v, src_t = torch.cat(values), torch.cat(targets)
    pos = torch.from_numpy(layout).to(src_v.device)
    pad = pos < 0
    pos = pos.clamp(min=0)
    lowest = torch.full((), -1, dtype=torch.int32, device=src_v.device).view(torch.float32)
    return (
        torch.where(pad, lowest, src_v[pos]),
        torch.where(pad, torch.zeros((), device=src_t.device), src_t[pos]),
    )


def _host_indexes(indexes) -> np.ndarray:
    idx = (
        indexes.detach().cpu().numpy()
        if isinstance(indexes, torch.Tensor)
        else np.asarray(indexes)
    )
    if idx.dtype.kind == "f":
        if not (np.isfinite(idx).all() and (idx == np.round(idx)).all()):
            raise ValueError("`indexes` must hold integers.")
        idx = idx.astype(np.int64)
    elif idx.dtype.kind not in "iub":
        raise ValueError(f"`indexes` must hold integers, got dtype {idx.dtype}.")
    return idx


class RetrievalPrecision(Metric[torch.Tensor]):
    """Retrieval precision @ k over one or more query streams.

    Args:
        empty_target_action: the value of a query whose buffered labels
            hold no positive: ``neg`` 0.0, ``pos`` 1.0, ``skip`` NaN,
            ``err`` raise.
        k: number of retrieved items considered (``None``: all).
        limit_k_to_size: divide by ``min(k, buffered)`` rather than ``k``.
        num_queries: number of query streams; updates route rows with
            ``indexes``.
        avg: ``"macro"`` averages over queries (NaN skipped); ``"none"``
            or ``None`` returns the per-query vector.
        device: where the state lives (CUDA by default).

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import RetrievalPrecision
    >>> metric = RetrievalPrecision(k=2, device="cpu")
    >>> _ = metric.update(torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2]),
    ...                   torch.tensor([0, 0, 1, 1, 1, 0, 1]))
    >>> metric.compute()
    tensor([0.5000])
    """

    def __init__(
        self,
        empty_target_action: str = "neg",
        k: Optional[int] = None,
        limit_k_to_size: bool = False,
        num_queries: int = 1,
        avg: Optional[str] = None,
        device: DeviceLike = None,
    ) -> None:
        _retrieval_precision_param_check(k, limit_k_to_size)
        if empty_target_action not in _EMPTY_TARGET_ACTIONS:
            raise ValueError(
                "empty_target_action must be one of 'neg', 'pos', 'skip', "
                f"'err', got {empty_target_action}."
            )
        if avg not in ("macro", "none", None):
            raise ValueError(f"avg must be 'macro', 'none' or None, got {avg}.")
        super().__init__(device=device)
        self.empty_target_action = empty_target_action
        self.num_queries = num_queries
        self.k = k
        self.limit_k_to_size = limit_k_to_size
        self.avg = avg
        self._add_state(
            "topk", [torch.zeros(0) for _ in range(num_queries)], merge=MergeKind.CUSTOM
        )
        self._add_state(
            "target", [torch.zeros(0) for _ in range(num_queries)], merge=MergeKind.CUSTOM
        )

    def update(self: TRetrievalPrecision, input, target, indexes=None) -> TRetrievalPrecision:
        """Accumulate scores and labels, routed to queries by ``indexes``."""
        input = narrow_64(self._input(input))
        target = narrow_64(self._input(target))
        _retrieval_precision_update_input_check(input, target)
        n = input.shape[0]
        if self.num_queries == 1:
            queries = np.zeros(1 if n else 0, dtype=np.int64)
            counts = np.full(queries.shape, n, dtype=np.int64)
            rows = np.arange(n, dtype=np.int64)
        else:
            if indexes is None:
                raise ValueError(
                    "`indexes` must be passed during update() when num_queries > 1."
                )
            idx = _host_indexes(indexes)
            if idx.shape != (n,):
                raise ValueError(
                    f"`indexes` shape {idx.shape} must match `input` shape ({n},)."
                )
            rows = np.flatnonzero((idx >= 0) & (idx < self.num_queries))
            rows = rows[np.argsort(idx[rows], kind="stable")]
            queries, counts = np.unique(idx[rows], return_counts=True)
        if queries.size:
            self._rank_into(queries, counts, rows, input, target)
        return self

    def _rank_into(self, queries, counts, rows, input, target) -> None:
        """Each query's new buffer: the top k of its old buffer followed by
        its batch rows (``rows``, grouped by query, batch order kept)."""
        lengths = np.array([self.topk[q].shape[-1] for q in queries], dtype=np.int64)
        layout = _row_layout(lengths, counts, rows)
        values, labels = _padded(
            layout,
            [self.topk[q] for q in queries] + [input.to(torch.float32)],
            [self.target[q] for q in queries] + [target.to(torch.float32)],
        )
        width = layout.shape[1]
        keep = width if self.k is None else min(self.k, width)
        top_values, top_idx = topk(values, keep)
        top_labels = torch.gather(labels, -1, top_idx.to(torch.int64))
        for j, (q, n) in enumerate(zip(queries.tolist(), (lengths + counts).tolist())):
            m = min(keep, n)
            self.topk[q] = top_values[j, :m]
            self.target[q] = top_labels[j, :m]

    def compute(self) -> torch.Tensor:
        """Per-query retrieval precision, or its macro average. A query
        with nothing buffered is NaN; one with no positive label takes
        ``empty_target_action``."""
        lengths = np.array([t.shape[-1] for t in self.target], dtype=np.int64)
        empty = lengths == 0
        if empty.all():
            result = torch.full((self.num_queries,), float("nan"), device=self.device)
        else:
            layout = _row_layout(lengths, np.zeros_like(lengths), np.zeros(0, dtype=np.int64))
            values, labels = _padded(layout, list(self.topk), list(self.target))
            width = layout.shape[1]
            _, top_idx = topk(values, width if self.k is None else min(self.k, width))
            relevant = torch.sum(torch.gather(labels, -1, top_idx.to(torch.int64)), dim=-1)
            precision = _precision(relevant, _nb_retrieved(lengths, self.k, self.limit_k_to_size))
            has_positive = torch.any(labels == 1, dim=-1).cpu().numpy()
            no_positive = ~empty & ~has_positive
            if no_positive.any() and self.empty_target_action == "err":
                first = int(np.flatnonzero(no_positive)[0])
                raise ValueError(f"no positive value found in target={self.target[first]}.")
            fill = np.where(
                no_positive, _EMPTY_TARGET_ACTIONS[self.empty_target_action], np.nan
            ).astype(np.float32)
            scored = torch.from_numpy(~empty & has_positive).to(self.device)
            result = torch.where(scored, precision, torch.from_numpy(fill).to(self.device))
        if self.avg == "macro":
            return torch.nanmean(result)
        return result

    def merge_state(
        self: TRetrievalPrecision, metrics: Iterable[TRetrievalPrecision]
    ) -> TRetrievalPrecision:
        """Concatenate each query's buffers, ours first, then the peers'
        in the order given."""
        metrics = list(metrics)
        for i in range(self.num_queries):
            self.topk[i] = torch.cat(
                [self.topk[i]] + [self._place_state(m.topk[i]) for m in metrics]
            )
            self.target[i] = torch.cat(
                [self.target[i]] + [self._place_state(m.target[i]) for m in metrics]
            )
        return self
