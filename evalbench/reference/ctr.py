"""Reference of a CTR eval panel, streamed batch by batch.

Each metric keeps its sums in ``dtype`` and adds each batch's sums to them,
as an eval loop does: float64 gives the reference, bfloat16 the control
(the step below the panel's float32 that a faster implementation might
take: bfloat16 inputs and sums). Definitions, for scores s in [0, 1] and
0/1 labels y over n samples, unit weights:

- NE: mean binary cross entropy (each log term clamped at -100, as
  ``torch.nn.functional.binary_cross_entropy``) over the entropy of the
  positive rate p = sum(y) / n;
- CTR: sum(y) / n; calibration: sum(s) / sum(y);
- exact AUROC: the trapezoidal area under the ROC curve with equal scores
  as one point; exact AUPRC: average precision, sum over distinct scores,
  descending, of (positives at that score / all positives) x precision at
  that score;
- binned AUROC and AUPRC: the same over the bin index floor(s x bins)
  (the last bin closed), each bin one tie group.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def _curves(pos: torch.Tensor, neg: torch.Tensor):
    """(AUROC, AUPRC) of tie groups given in descending score order, with
    the arithmetic in the tensors' dtype."""
    total_pos, total_neg = pos.sum(), neg.sum()
    tp = torch.cumsum(pos, 0)
    fp = torch.cumsum(neg, 0)
    auroc = (neg * (tp - pos + pos / 2)).sum() / (total_pos * total_neg)
    has = pos > 0
    auprc = (pos[has] / total_pos * tp[has] / (tp[has] + fp[has])).sum()
    return auroc, auprc


def _entropy(p: float) -> float:
    return -(p * math.log(p) + (1 - p) * math.log(1 - p))


class _Metric:
    def __init__(self, dtype, device) -> None:
        self.dtype, self.device = dtype, device

    def _zero(self, *shape):
        return torch.zeros(shape, dtype=self.dtype, device=self.device)


class NE(_Metric):
    def __init__(self, dtype, device) -> None:
        super().__init__(dtype, device)
        self.ce, self.pos, self.n = self._zero(), self._zero(), self._zero()

    def update(self, s, y) -> None:
        logs = torch.clamp(torch.log(s), min=-100.0)
        log1m = torch.clamp(torch.log1p(-s), min=-100.0)
        self.ce += -(y * logs + (1 - y) * log1m).sum()
        self.pos += y.sum()
        self.n += torch.ones_like(y).sum()

    def value(self) -> float:
        n = float(self.n)
        return float(self.ce) / n / _entropy(float(self.pos) / n)


class CTR(_Metric):
    def __init__(self, dtype, device) -> None:
        super().__init__(dtype, device)
        self.clicks, self.n = self._zero(), self._zero()

    def update(self, s, y) -> None:
        self.clicks += y.sum()
        self.n += torch.ones_like(y).sum()

    def value(self) -> float:
        return float(self.clicks) / float(self.n)


class Calibration(_Metric):
    def __init__(self, dtype, device) -> None:
        super().__init__(dtype, device)
        self.s, self.y = self._zero(), self._zero()

    def update(self, s, y) -> None:
        self.s += s.sum()
        self.y += y.sum()

    def value(self) -> float:
        return float(self.s) / float(self.y)


class Binned(_Metric):
    """Binned AUROC (``which="auroc"``) or AUPRC over ``num_bins`` bins of
    [0, 1]."""

    def __init__(self, dtype, device, which: str, num_bins: int) -> None:
        super().__init__(dtype, device)
        self.which, self.bins = which, int(num_bins)
        self.pos, self.neg = self._zero(self.bins), self._zero(self.bins)

    def update(self, s, y) -> None:
        b = torch.clamp(torch.floor(torch.clamp(s, 0, 1) * self.bins), max=self.bins - 1).long()
        self.pos += torch.bincount(b, weights=y.double(), minlength=self.bins).to(self.dtype)
        self.neg += torch.bincount(b, weights=(1 - y).double(), minlength=self.bins).to(self.dtype)

    def value(self) -> float:
        auroc, auprc = _curves(self.pos.flip(0), self.neg.flip(0))
        return float(auroc if self.which == "auroc" else auprc)


class Exact(_Metric):
    """Exact AUROC (``which="auroc"``) or AUPRC: every score kept (rounded
    to ``dtype``), tie groups counted in ``dtype``."""

    def __init__(self, dtype, device, which: str) -> None:
        super().__init__(dtype, device)
        self.which = which
        self.keys, self.labels = [], []

    def update(self, s, y) -> None:
        self.keys.append(s.to(self.dtype))
        self.labels.append(y.to(self.dtype))

    def value(self) -> float:
        keys, labels = torch.cat(self.keys), torch.cat(self.labels)
        groups, inverse = torch.unique(keys, sorted=True, return_inverse=True)
        pos = torch.zeros(groups.numel(), dtype=self.dtype, device=keys.device)
        pos.index_add_(0, inverse, labels)
        neg = torch.zeros_like(pos)
        neg.index_add_(0, inverse, 1 - labels)
        auroc, auprc = _curves(pos.flip(0), neg.flip(0))
        return float(auroc if self.which == "auroc" else auprc)


def make(kind: str, dtype, device, **args) -> _Metric:
    """The reference metric of ``kind`` (a panel entry's ``reference``)."""
    if kind == "ne":
        return NE(dtype, device)
    if kind == "ctr":
        return CTR(dtype, device)
    if kind == "calibration":
        return Calibration(dtype, device)
    if kind in ("binned_auroc", "binned_auprc"):
        return Binned(dtype, device, kind.split("_")[1], args["num_bins"])
    if kind in ("exact_auroc", "exact_auprc"):
        return Exact(dtype, device, kind.split("_")[1])
    raise KeyError(f"no reference for {kind!r}")


def panel_values(panel: list, scores: torch.Tensor, labels: torch.Tensor, batch: int,
                 dtype=torch.float64) -> Dict[str, float]:
    """Each panel entry's value over one pass of ``batch``-sized batches,
    with every input and sum in ``dtype``."""
    refs = {m["name"]: make(m["reference"], dtype, scores.device, **m.get("args", {}))
            for m in panel}
    for a in range(0, scores.numel(), batch):
        s = scores[a:a + batch].to(dtype)
        y = labels[a:a + batch].to(dtype)
        for r in refs.values():
            r.update(s, y)
    return {k: r.value() for k, r in refs.items()}
