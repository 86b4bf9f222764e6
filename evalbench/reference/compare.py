"""The numbers compared with the reference, as functions of outputs.

A run passes its program's outputs, a control passes its own; both are
judged by the same functions. Each number is a distance (0 is perfect)
that the run's ``limits/<cell>.json`` bounds; a number that could not be
taken (no pass finished, a checked step never ran) is NaN, and NaN never
passes.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

NAN = float("nan")


def rel(got: float, want: float) -> float:
    return abs(got - want) / abs(want) if want else abs(got - want)


def panel_readings(passes: List[Dict[str, float]], ref: Dict[str, float]) -> Dict[str, float]:
    """``<metric>_rel``: the largest relative gap, over the passes, of each
    panel metric's value from the reference's."""
    return {f"{k}_rel": max((rel(p[k], want) for p in passes), default=NAN)
            for k, want in ref.items()}


def count_gap(held: List[Dict[str, float]], n: int) -> float:
    """Samples miscounted: the largest gap, over the passes and the panel's
    counting metrics, between the samples a metric holds at a pass end and
    the ``n`` of the eval set (exact: limit 0)."""
    return max((abs(c - n) for h in held for c in h.values()), default=0.0)


def _token_nll(logits: torch.Tensor, targets: torch.Tensor, rows: int = 1024) -> torch.Tensor:
    """float64 negative log-likelihood of each target under ``logits``
    (N, V), in blocks of ``rows``."""
    out = []
    for a in range(0, logits.shape[0], rows):
        z = logits[a:a + rows].double()
        t = targets[a:a + rows].long()
        out.append(torch.logsumexp(z, dim=-1) - z.gather(1, t[:, None]).squeeze(1))
    return torch.cat(out)


def _argmax_hits(logits: torch.Tensor, targets: torch.Tensor, rows: int = 1024) -> int:
    return int(sum(int((logits[a:a + rows].argmax(-1) == targets[a:a + rows]).sum())
                   for a in range(0, logits.shape[0], rows)))


def step_readings(logits: torch.Tensor, delta: Dict[str, float], ref_logits: torch.Tensor,
                  targets: torch.Tensor) -> Dict[str, float]:
    """One checked eval step: ``logits`` (N, V) as the step produced them,
    ``delta`` the metric states' change over the step (``sum_log_probs``,
    ``ppl_count``, ``acc_correct``, ``acc_count``), ``ref_logits`` the
    reference's, ``targets`` (N,).

    - ``logit_rms_rel``: RMS of the logits' gap over RMS of the
      reference's logits;
    - ``token_nll_gap_max``: the widest gap of a token's NLL under the
      step's logits from its NLL under the reference's;
    - ``nll_sum_gap``: the perplexity state's NLL sum over the step
      against the float64 NLL sum of the step's own logits, in nats a
      token (the bridge: the program keeps each step's sum in its logits'
      dtype, within half a step of it);
    - ``count_gap``: tokens miscounted (both metrics' totals against the
      tokens of the step, the correct-prediction count against the argmax
      hits of the step's own logits): exact, limit 0.
    """
    num = den = 0.0
    for a in range(0, logits.shape[0], 1024):
        z, r = logits[a:a + 1024].double(), ref_logits[a:a + 1024].double()
        num += float(((z - r) ** 2).sum())
        den += float((r ** 2).sum())
    nll = _token_nll(logits, targets)
    nll_ref = _token_nll(ref_logits, targets)
    n = targets.numel()
    return {
        "logit_rms_rel": math.sqrt(num / den),
        "token_nll_gap_max": float((nll - nll_ref).abs().max()),
        "nll_sum_gap": abs(delta["sum_log_probs"] - float(nll.sum())) / n,
        "count_gap": abs(delta["ppl_count"] - n) + abs(delta["acc_count"] - n)
        + abs(delta["acc_correct"] - _argmax_hits(logits, targets)),
    }


STEP_NUMBERS = ("logit_rms_rel", "token_nll_gap_max", "nll_sum_gap", "count_gap")


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    """Each step number's largest reading over ``readings``, NaN where
    there is none."""
    return {k: max((r[k] for r in readings), default=NAN) for k in STEP_NUMBERS}


def perplexity_value_rel(value: float, sum_log_probs: float, count: float) -> float:
    """The perplexity reported against exp(NLL sum / count) of the states
    it was computed from, in float64."""
    if count <= 0:
        return NAN
    return rel(value, math.exp(sum_log_probs / count))
