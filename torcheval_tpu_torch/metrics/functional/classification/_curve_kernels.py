"""Shared computations of the sort/threshold-curve metrics (AUROC, AUPRC,
precision-recall curves, recall at fixed precision).

Counterpart of ``torcheval_tpu/metrics/functional/classification/
_curve_kernels.py`` (:35-366), in plain torch ops. Every array keeps the
sample count ``n`` along the last axis:

1. sort scores descending (``sort_desc``); cumulate TP/FP;
2. mark tie-run ends (``threshold[i] != threshold[i + 1]``, the last
   element always an end);
3. replace each element by its run end's cumulative value with a reverse
   cummin (cumulative sums do not decrease, so the nearest run end to the
   right is the suffix minimum of the run-end values), scanned in two
   levels so a long row runs in parallel on CUDA;
4. integrate: repeated points of a run have ``dx == 0`` and add nothing,
   so the trapezoid and Riemann sums equal those over the compacted curve.

The JAX package's CPU FFI area kernels (``binary_auroc_area``,
``binary_auprc_area``) fuse this chain on the CPU; they are CPU kernels,
not TPU kernels, and here stay the plain formulation.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from torcheval_tpu_torch.utils.convert import (
    DeviceLike,
    functional_device,
    narrow_64,
    to_torch,
)

_INT32_MAX = 0x7FFFFFFF
_NAN_KEY = 0x7FC00000  # one positive NaN: above +inf in the key order
_SCAN_BLOCK = 4096  # samples a row of the two-level reverse cummin


def _descending_key(input: torch.Tensor) -> torch.Tensor:
    """An integer key whose ascending stable sort is the descending sort
    of ``input`` as ``jnp.argsort(-x, stable=True)`` orders it.

    Floats go through their bits (float32; float16/bfloat16 widen to it
    exactly): ``-x`` with ``-0.0`` folded into ``+0.0`` and every NaN
    into one positive NaN, then the sign-magnitude bits map to an int32
    order (negative values flip their magnitude bits). So ties keep their
    index order, ``-0.0`` ties ``+0.0``, NaN of either sign sorts last,
    and the order is the same whatever sort the device runs (a radix sort
    on float bits would put ``-0.0`` before ``+0.0`` and a negative NaN
    first)."""
    if not input.is_floating_point():
        return -input
    x = input if input.dtype in (torch.float32, torch.float64) else input.to(torch.float32)
    if x.dtype == torch.float64:
        bits_dtype, nan_key, flip = torch.int64, 0x7FF8000000000000, 0x7FFFFFFFFFFFFFFF
    else:
        bits_dtype, nan_key, flip = torch.int32, _NAN_KEY, _INT32_MAX
    neg = -x + 0.0  # + 0.0 turns -0.0 into +0.0 and changes nothing else
    bits = neg.view(bits_dtype)
    bits = torch.where(torch.isnan(neg), torch.full_like(bits, nan_key), bits)
    return torch.where(bits < 0, bits ^ flip, bits)


def sort_desc(input: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable descending sort along the last axis: ``(sorted_scores,
    order)``, ordered as ``jnp.argsort(-x, stable=True)`` orders them (ties
    keep ascending index, NaN of either sign last, ``-0.0`` ties
    ``+0.0``)."""
    order = torch.argsort(_descending_key(input), dim=-1, stable=True)
    return torch.gather(input, -1, order), order


def _run_end_mask(sorted_scores: torch.Tensor) -> torch.Tensor:
    """True at the last element of each equal-score run (last axis)."""
    neq = sorted_scores[..., 1:] != sorted_scores[..., :-1]
    last = torch.ones(sorted_scores.shape[:-1] + (1,), dtype=torch.bool, device=neq.device)
    return torch.cat([neq, last], dim=-1)


def _reverse_cummin(x: torch.Tensor) -> torch.Tensor:
    """Suffix minimum along the last axis, ``flip(cummin(flip(x)))``, as a
    two-level scan over blocks of ``_SCAN_BLOCK``: torch's CUDA cummin
    scans each row in one sequential pass, so one 2^27-sample row took
    0.72 s (NVIDIA H100 80GB HBM3, 700.00 W; ``chip_smoke.py`` curve phase),
    where many short rows scan in parallel. A minimum rounds nothing, so
    the two levels give the one-level scan's values, NaN included."""
    n = x.shape[-1]
    flipped = torch.flip(x, dims=(-1,))
    if n <= _SCAN_BLOCK:
        return torch.flip(torch.cummin(flipped, dim=-1).values, dims=(-1,))
    blocks = -(-n // _SCAN_BLOCK)
    inf = float("inf")
    lead = flipped.shape[:-1]
    if blocks * _SCAN_BLOCK > n:  # +inf after the last element changes no prefix
        flipped = torch.cat([flipped, flipped.new_full(lead + (blocks * _SCAN_BLOCK - n,), inf)], -1)
    within = torch.cummin(flipped.reshape(lead + (blocks, _SCAN_BLOCK)), dim=-1).values
    carry = torch.cummin(within[..., -1], dim=-1).values  # through each block
    before = torch.cat([carry.new_full(lead + (1,), inf), carry[..., :-1]], dim=-1)
    scanned = torch.minimum(within, before[..., None]).reshape(lead + (-1,))[..., :n]
    return torch.flip(scanned, dims=(-1,))


def _propagate_run_end(values: torch.Tensor, is_end: torch.Tensor) -> torch.Tensor:
    """Replace every element with its tie-run end's value. ``values`` must
    not decrease along the last axis (cumulative sums do not)."""
    return _reverse_cummin(torch.where(is_end, values, torch.full_like(values, float("inf"))))


def roc_cumulators(
    input: torch.Tensor,
    target: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sorted thresholds and tie-compacted cumulative TP/FP: ``(threshold,
    cum_tp, cum_fp, is_run_end)``, each shaped like ``input`` with the last
    axis in descending-score order."""
    threshold, order = sort_desc(input)
    starget = torch.gather(target, -1, order).to(torch.float32)
    if weight is None:
        sweight = torch.ones_like(starget)
    else:
        sweight = torch.gather(weight, -1, order).to(torch.float32)
    cum_tp = torch.cumsum(sweight * starget, dim=-1)
    cum_fp = torch.cumsum(sweight * (1.0 - starget), dim=-1)
    is_end = _run_end_mask(threshold)
    return (
        threshold,
        _propagate_run_end(cum_tp, is_end),
        _propagate_run_end(cum_fp, is_end),
        is_end,
    )


def auroc_from_cumulators(cum_tp: torch.Tensor, cum_fp: torch.Tensor) -> torch.Tensor:
    """Trapezoidal AUROC over the (FP, TP) curve with the (0, 0) origin
    prepended; all-positive or all-negative tasks give 0.5."""
    zeros = torch.zeros(cum_tp.shape[:-1] + (1,), dtype=cum_tp.dtype, device=cum_tp.device)
    y = torch.cat([zeros, cum_tp], dim=-1)
    x = torch.cat([zeros, cum_fp], dim=-1)
    dx = x[..., 1:] - x[..., :-1]
    area = torch.sum(dx * (y[..., 1:] + y[..., :-1]) / 2.0, dim=-1)
    factor = cum_tp[..., -1] * cum_fp[..., -1]
    degenerate = factor == 0
    return torch.where(
        degenerate,
        torch.full_like(area, 0.5),
        area / torch.where(degenerate, torch.ones_like(factor), factor),
    )


def prc_arrays(
    input: torch.Tensor, target: torch.Tensor, pos_label: int = 1
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-length precision, recall, threshold and run-end arrays in
    ascending-threshold order. The terminal (precision 1, recall 0) point
    is not included; recall is 1.0 throughout when there is no positive."""
    threshold, order = sort_desc(input)
    hit = (torch.gather(target, -1, order) == pos_label).to(torch.float32)
    is_end = _run_end_mask(threshold)
    num_tp = _propagate_run_end(torch.cumsum(hit, dim=-1), is_end)
    num_fp = _propagate_run_end(torch.cumsum(1.0 - hit, dim=-1), is_end)
    precision = num_tp / (num_tp + num_fp)
    total_tp = num_tp[..., -1:]
    no_pos = total_tp == 0
    recall = torch.where(
        no_pos,
        torch.ones_like(num_tp),
        num_tp / torch.where(no_pos, torch.ones_like(total_tp), total_tp),
    )
    flip = (-1,)
    return (
        torch.flip(precision, flip),
        torch.flip(recall, flip),
        torch.flip(threshold, flip),
        torch.flip(is_end, flip),
    )


def auprc_from_prc(precision: torch.Tensor, recall: torch.Tensor) -> torch.Tensor:
    """Left-Riemann AUPRC over ascending-threshold (descending-recall)
    points with the terminal (p=1, r=0) appended; repeated points of a
    tie run add nothing."""
    ones = torch.ones(precision.shape[:-1] + (1,), dtype=precision.dtype, device=precision.device)
    p = torch.cat([precision, ones], dim=-1)
    r = torch.cat([recall, torch.zeros_like(ones, dtype=recall.dtype)], dim=-1)
    return -torch.sum((r[..., 1:] - r[..., :-1]) * p[..., :-1], dim=-1)


def _max_last(x: torch.Tensor, initial: float) -> torch.Tensor:
    """``jnp.max(x, axis=-1, initial=initial)``: NaN propagates, and an
    empty last axis gives ``initial``."""
    init = torch.full(x.shape[:-1], initial, dtype=x.dtype, device=x.device)
    if x.shape[-1] == 0:
        return init
    return torch.maximum(torch.amax(x, dim=-1), init)


def recall_at_precision_from_arrays(
    precision: torch.Tensor,
    recall: torch.Tensor,
    threshold: torch.Tensor,
    is_end: torch.Tensor,
    min_precision: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Max recall subject to ``precision >= min_precision``, and the
    largest threshold attaining it, over the full-length arrays: repeated
    points of a tie run are masked out, and the terminal point (recall 0,
    threshold -1) takes part, as in the reference."""
    ok = is_end & (precision >= min_precision)
    max_recall = _max_last(torch.where(ok, recall, torch.zeros_like(recall)), 0.0)
    # the threshold step filters by recall only; ineligible slots are
    # -inf, not the -1 terminal, which would shadow negative thresholds
    eligible = is_end & (recall == max_recall[..., None])
    if not threshold.is_floating_point():
        # integer scores: JAX promotes them to float32 against the -inf fill
        threshold = threshold.to(torch.float32)
    candidate = _max_last(
        torch.where(eligible, threshold, torch.full_like(threshold, float("-inf"))),
        float("-inf"),
    )
    best = torch.where(
        max_recall == 0, torch.clamp(candidate, min=-1.0), candidate
    )
    return max_recall, torch.abs(best)


def binary_auroc_area(
    input: torch.Tensor,
    target: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Tie-compacted trapezoidal AUROC over the last axis."""
    _, cum_tp, cum_fp, _ = roc_cumulators(input, target, weight)
    return auroc_from_cumulators(cum_tp, cum_fp)


def binary_auprc_area(input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Left-Riemann AUPRC (positives are ``target == 1``) over the last
    axis."""
    p, r, _, _ = prc_arrays(input, target, 1)
    return auprc_from_prc(p, r)


def _curve_inputs(device: DeviceLike, *inputs) -> tuple:
    """A curve entry point's inputs as tensors on one device (see
    ``functional_device``), 64-bit dtypes narrowed as the JAX package's
    arrays hold them; ``None`` stays ``None``."""
    dev = functional_device(device, *inputs)
    return tuple(
        None if x is None else narrow_64(to_torch(x, device=dev)) for x in inputs
    )
