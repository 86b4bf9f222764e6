"""Per-key metric families of the keyed metric table (counterpart of
``torcheval_tpu/table/_families.py``).

A :class:`TableFamily` adapts one of the library's metric families to the
table's ROW layout: instead of one metric instance per key, the table keeps
each family's sufficient statistics as **columns** (one float32
accumulator per field with a leading key-slot axis), and the family
supplies three pieces:

- ``prepare``: validation and coercion of ``ingest``'s per-row arguments
  onto the table's device (the ``_input`` boundary);
- ``row_kernel``: per-row payload columns, run inside the table's ingest
  (one float32 value per field per row; the table segment-sums owned rows
  into the slot columns and ships foreign rows through the outbox). The
  per-row arithmetic is the standalone family's own (the hit-rate rank
  and the binary NE cross entropy are imported from their modules), which
  is what makes the per-key values equal the standalone metrics';
- ``compute``: the per-key finalization over the columns, elementwise the
  expression the standalone metric applies to its scalar counters.

Windowed families also declare ``window``: the table keeps a per-key ring
of the last ``window`` DRAIN EPOCHS, committed at the drain point
(``MetricTable.adopt`` / ``toolkit.adopt_synced``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from torcheval_tpu_torch.metrics.functional.classification.binary_normalized_entropy import (
    _baseline_update,
    _ne_ce_rows,
)
from torcheval_tpu_torch.metrics.functional.ranking.hit_rate import _target_rank
from torcheval_tpu_torch.utils.convert import cached_scalar

__all__ = [
    "TableFamily",
    "resolve_family",
    "FAMILIES",
    "windowed_fields",
    "traffic_fields",
]


class TableFamily(NamedTuple):
    """One per-key metric family (see the module docstring).

    ``fields`` name the float32 accumulator columns; ``prepare(table,
    *args, **kwargs)`` returns the per-row dynamic argument tuple
    (row-aligned with the keys) and the hashable config tuple;
    ``row_kernel(*dynamic, *config)`` returns one per-row float32 vector
    per field; ``compute(cols)`` maps ``{field: values[n]}`` to the per-key
    result. ``window > 0`` marks an epoch-windowed family: its fields are
    the PENDING (current-epoch) accumulators, committed into per-key rings
    of ``window`` columns at each drain.

    ``window_fields`` restricts the ring treatment to a subset of
    ``fields`` (empty: all fields when ``window > 0``), so a composite
    panel family can hold windowed and cumulative member columns under one
    epoch clock. ``traffic_fields`` names the columns whose nonzero
    pending value marks "this key saw traffic this epoch" (OR-combined);
    empty applies the default: ``num_examples`` if it is windowed, else
    the last windowed field.
    """

    name: str
    fields: Tuple[str, ...]
    prepare: Callable[..., Tuple[Tuple, Tuple]]
    row_kernel: Callable[..., Tuple[torch.Tensor, ...]]
    compute: Callable[[Dict[str, torch.Tensor]], Any]
    window: int = 0
    window_fields: Tuple[str, ...] = ()
    traffic_fields: Tuple[str, ...] = ()


def windowed_fields(family: "TableFamily") -> Tuple[str, ...]:
    """The fields that keep per-key epoch rings (empty when windowless)."""
    if not family.window:
        return ()
    return tuple(family.window_fields) or tuple(family.fields)


def traffic_fields(family: "TableFamily") -> Tuple[str, ...]:
    """The fields whose nonzero pending column marks epoch traffic."""
    wf = windowed_fields(family)
    if not wf:
        return ()
    if family.traffic_fields:
        return tuple(family.traffic_fields)
    return ("num_examples",) if "num_examples" in wf else (wf[-1],)


def _rows_1d(table, name: str, value, *, dtype=None) -> torch.Tensor:
    arr = table._input(value, dtype=dtype)
    if arr.ndim != 1:
        raise ValueError(
            f"table family {table.family.name!r}: `{name}` must be a "
            f"one-dimensional per-row array, got shape {tuple(arr.shape)}"
        )
    return arr


def _weight_rows(table, weights, like):
    """Per-row weights: a scalar broadcasts inside the row kernel (a cached
    0-d tensor on the table's device, so nothing is uploaded a call)."""
    if isinstance(weights, (int, float)):
        return cached_scalar(float(weights), device=table.device)
    return _rows_1d(table, "weights", weights)


def _same_rows(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.shape != b.shape:
        raise ValueError(
            f"`preds` shape ({tuple(a.shape)}) is different from `targets` "
            f"shape ({tuple(b.shape)})"
        )


# ------------------------------------------------------------------- ctr


def _ctr_rows(clicks, weights):
    w = torch.broadcast_to(weights.to(torch.float32), clicks.shape)
    return clicks.to(torch.float32) * w, w


def _ctr_prepare(table, clicks, weights=1.0):
    clicks = _rows_1d(table, "clicks", clicks)
    return (clicks, _weight_rows(table, weights, clicks)), ()


def _ctr_compute(cols):
    # the standalone formula: a tiny-eps guard, so a key with zero weight
    # reads 0.0, not NaN
    return cols["click"] / (cols["weight"] + torch.finfo(torch.float32).tiny)


# ------------------------------------------------------ weighted calibration


def _wc_rows(preds, targets, weights):
    w = torch.broadcast_to(weights.to(torch.float32), preds.shape)
    return w * preds.to(torch.float32), w * targets.to(torch.float32)


def _wc_prepare(table, preds, targets, weights=1.0):
    preds = _rows_1d(table, "preds", preds)
    targets = _rows_1d(table, "targets", targets)
    _same_rows(preds, targets)
    return (preds, targets, _weight_rows(table, weights, preds)), ()


def _wc_compute(cols):
    wt = cols["weighted_target"]
    # a key with zero target mass reads 0.0 (the standalone metric returns
    # an empty result there; a table needs a value a slot)
    return torch.where(wt != 0.0, cols["weighted_input"] / wt, 0.0)


# -------------------------------------------------------------- hit rate


def _hit_rows(scores, targets, k):
    # the standalone per-example rank (functional.ranking.hit_rate)
    ones = torch.ones(targets.shape, dtype=torch.float32, device=targets.device)
    if k is None or k >= scores.shape[-1]:
        return ones, ones
    hits = (_target_rank(scores, targets.to(torch.int32)) < k).to(torch.float32)
    return hits, ones


def _hit_prepare(table, scores, targets):
    scores = table._input(scores)
    targets = _rows_1d(table, "targets", targets)
    if scores.ndim != 2:
        raise ValueError(
            "table family 'hit_rate': `scores` must be "
            f"(num_rows, num_classes), got shape {tuple(scores.shape)}"
        )
    if scores.shape[0] != targets.shape[0]:
        raise ValueError(
            "`input` and `target` should have the same minibatch "
            f"dimension, got shapes {tuple(scores.shape)} and "
            f"{tuple(targets.shape)}, respectively."
        )
    return (scores, targets), (table.k,)


def _hit_compute(cols):
    n = cols["count"]
    return torch.where(n != 0.0, cols["hit"] / n, 0.0)


# ----------------------------------------------------------- windowed NE


def _ne_rows(preds, targets, weights, from_logits):
    ce, t = _ne_ce_rows(preds, targets, from_logits)
    w = torch.broadcast_to(weights.to(torch.float32), t.shape)
    return w * ce, w, w * t


def _ne_prepare(table, preds, targets, weights=1.0):
    preds = _rows_1d(table, "preds", preds)
    targets = _rows_1d(table, "targets", targets)
    _same_rows(preds, targets)
    return (preds, targets, _weight_rows(table, weights, preds)), (table.from_logits,)


def _ne_compute(cols):
    ex = cols["num_examples"]
    safe = torch.where(ex != 0.0, ex, 1.0)
    ne = (cols["total_entropy"] / safe) / _baseline_update(cols["num_positive"], safe)
    return torch.where(ex != 0.0, ne, 0.0)


FAMILIES: Dict[str, TableFamily] = {
    "ctr": TableFamily(
        name="ctr",
        fields=("click", "weight"),
        prepare=_ctr_prepare,
        row_kernel=_ctr_rows,
        compute=_ctr_compute,
    ),
    "weighted_calibration": TableFamily(
        name="weighted_calibration",
        fields=("weighted_input", "weighted_target"),
        prepare=_wc_prepare,
        row_kernel=_wc_rows,
        compute=_wc_compute,
    ),
    "hit_rate": TableFamily(
        name="hit_rate",
        fields=("hit", "count"),
        prepare=_hit_prepare,
        row_kernel=_hit_rows,
        compute=_hit_compute,
    ),
    "windowed_ne": TableFamily(
        name="windowed_ne",
        fields=("total_entropy", "num_examples", "num_positive"),
        prepare=_ne_prepare,
        row_kernel=_ne_rows,
        compute=_ne_compute,
        window=1,  # placeholder; resolve_family applies the window size
    ),
    # cumulative NE: windowed_ne's rows and compute with no epoch ring, so
    # it can join a TablePanel beside the other cumulative families
    "ne": TableFamily(
        name="ne",
        fields=("total_entropy", "num_examples", "num_positive"),
        prepare=_ne_prepare,
        row_kernel=_ne_rows,
        compute=_ne_compute,
    ),
}


def resolve_family(family, **kwargs) -> Tuple[TableFamily, Dict[str, Any]]:
    """``family`` (name or :class:`TableFamily`) plus family kwargs -> the
    resolved adapter and the attribute dict the table stores (``k``,
    ``from_logits``, the window size)."""
    if isinstance(family, TableFamily):
        fam = family
    else:
        fam = FAMILIES.get(str(family))
        if fam is None:
            raise ValueError(f"unknown table family {family!r}; available: {sorted(FAMILIES)}")
    attrs: Dict[str, Any] = {}
    if fam.name == "hit_rate":
        k = kwargs.pop("k", None)
        if k is not None and int(k) <= 0:
            raise ValueError(f"k should be None or positive, got {k}.")
        attrs["k"] = None if k is None else int(k)
    if fam.name in ("windowed_ne", "ne"):
        attrs["from_logits"] = bool(kwargs.pop("from_logits", False))
    if fam.name == "windowed_ne":
        window = int(kwargs.pop("window", 16))
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        fam = fam._replace(window=window)
    if kwargs:
        raise TypeError(f"unexpected table family arguments for {fam.name!r}: {sorted(kwargs)}")
    return fam, attrs
