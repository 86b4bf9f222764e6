"""Fused sort-free approximate AUC.

Counterpart of ``torcheval_tpu/ops/fused_auc.py``. Scores (min/max
normalized per task, or mapped through fixed ``bounds``) are binned into a
(num_tasks, 2, num_bins) histogram of positive/negative weight mass in one
streaming pass, and

    AUC = sum_b wneg[b] * (pos_above[b] + wpos[b]/2) / (Wp * Wn)

is read off it: exact up to ties at bin resolution.

The JAX package's backend strings (``auto|pallas|native|xla``) do not carry
over. There are two paths, chosen by where the scores lie:

- a CUDA tensor goes through the hand-written Hopper kernel
  (``csrc/fused_auc_hist.cu``, replacing the Pallas ``_hist_kernel``); its
  wrapper launches it or raises -- there is no fallback;
- a CPU tensor goes through ``_histogram_plain``, the plain PyTorch
  version that mirrors the JAX package's ``_histogram_xla``.

Both compute the same bins, bit for bit: the fixed-bounds rescale is
``(s - lo) * inv_span`` with ``inv_span`` the float32 reciprocal of the
float32 span (what XLA makes of the JAX package's ``(s - lo) / (hi - lo)``
with constant bounds), the per-task rescale is a true division, and a NaN
score lands in bin 0 (fixed bounds) or poisons its task's span so that the
whole task falls into the 0.5 bin (``bounds=None``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from torcheval_tpu_torch.ops import _kernels
from torcheval_tpu_torch.utils.convert import (
    DeviceLike,
    functional_device,
    to_torch,
    to_torch_float,
)

DEFAULT_NUM_BINS = 8192

# a block's shared-memory histogram is 2 * num_bins float32; above this the
# kernel's global-memory variant is used (Hopper opts in to 227 KB a block)
_SHARED_HIST_MAX_BYTES = 200 * 1024
# samples a block of the shared variant should cover, so that zeroing and
# flushing its 2 * num_bins histogram stays a small share of its work
_MIN_SAMPLES_PER_BLOCK = 1024


def _auc_from_hist(hist: torch.Tensor) -> torch.Tensor:
    """(T, 2, B) weight histograms -> (T,) AUC."""
    wpos = hist[:, 0, :]
    wneg = hist[:, 1, :]
    total_pos = torch.sum(wpos, dim=-1, keepdim=True)
    pos_above = total_pos - torch.cumsum(wpos, dim=-1)  # strictly-higher bins
    num = torch.sum(wneg * (pos_above + 0.5 * wpos), dim=-1)
    denom = total_pos[:, 0] * torch.sum(wneg, dim=-1)
    # degenerate single-class tasks -> 0.5
    positive = denom > 0
    return torch.where(
        positive,
        num / torch.where(positive, denom, torch.ones_like(denom)),
        torch.full_like(denom, 0.5),
    )


def _auprc_from_hist(hist: torch.Tensor) -> torch.Tensor:
    """(T, 2, B) weight histograms -> (T,) AUPRC (average precision):
    Riemann sum in descending-score order, each bin one tie group; no
    positives -> 0, all positives -> 1."""
    wpos = torch.flip(hist[:, 0, :], dims=(-1,))
    wneg = torch.flip(hist[:, 1, :], dims=(-1,))
    tp = torch.cumsum(wpos, dim=-1)
    fp = torch.cumsum(wneg, dim=-1)
    total_pos = tp[:, -1:]
    precision = tp / torch.clamp(tp + fp, min=1e-30)
    delta_recall = wpos / torch.clamp(total_pos, min=1e-30)
    return torch.sum(precision * delta_recall, dim=-1)


def _as_2d(
    input: torch.Tensor, target: torch.Tensor, weight: Optional[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Scores as float32 (T, n); labels and weights broadcast to the same
    shape as expanded views (a 1-D weight shared by every task is not
    copied). An absent weight stays ``None``: unit weights are implicit."""
    scores = torch.atleast_2d(input).to(torch.float32)
    labels = torch.atleast_2d(target).to(torch.float32).expand(scores.shape)
    if weight is not None:
        weight = torch.atleast_2d(weight).to(torch.float32).expand(scores.shape)
    return scores, labels, weight


def _normalize_scores(scores: torch.Tensor) -> torch.Tensor:
    """Per-task min/max rescale to [0, 1] (AUC is rank-invariant); a task
    whose span is not positive (constant scores, or a NaN anywhere) maps
    to 0.5 throughout."""
    lo, span = _task_lo_span(scores)
    positive = span > 0
    return torch.where(
        positive,
        (scores - lo) / torch.where(positive, span, torch.ones_like(span)),
        torch.full_like(scores, 0.5),
    )


def _task_lo_span(scores: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, 1) per-task minimum and span (NaN-propagating, like jnp.min)."""
    lo = torch.amin(scores, dim=-1, keepdim=True)
    hi = torch.amax(scores, dim=-1, keepdim=True)
    return lo, hi - lo


def _fixed_bounds(bounds: Tuple[float, float]) -> Tuple[np.float32, np.float32]:
    """(lo, inv_span) in float32: ``inv_span = 1 / float32(hi - lo)``,
    the span taken in Python double as the JAX package takes it."""
    lo, hi = bounds
    return np.float32(lo), np.float32(1.0) / np.float32(hi - lo)


def _rescale_fixed(scores: torch.Tensor, bounds: Tuple[float, float]) -> torch.Tensor:
    lo, inv_span = _fixed_bounds(bounds)
    # float32 operands as tensors, so the arithmetic stays float32
    lo_t = torch.tensor(lo, device=scores.device)
    inv_t = torch.tensor(inv_span, device=scores.device)
    return torch.clamp((scores - lo_t) * inv_t, 0.0, 1.0)


def _histogram_plain(
    scores: torch.Tensor,
    labels: torch.Tensor,
    weights: torch.Tensor,
    num_bins: int,
) -> torch.Tensor:
    """Plain PyTorch histogram of scores already mapped to [0, 1]: the
    mirror of the JAX package's ``_histogram_xla`` (scatter-add, no
    one-hot). A NaN score lands in bin 0, as XLA's float->int32 cast puts
    it (torch's CPU cast would give INT32_MIN)."""
    s = torch.nan_to_num(torch.clamp(scores, 0.0, 1.0), nan=0.0)
    bins = torch.clamp((s * num_bins).to(torch.int64), 0, num_bins - 1)
    num_tasks = scores.shape[0]
    flat = (
        bins + torch.arange(num_tasks, device=scores.device)[:, None] * num_bins
    ).reshape(-1)
    wpos = torch.zeros(num_tasks * num_bins, dtype=torch.float32, device=scores.device)
    wneg = torch.zeros_like(wpos)
    wpos.index_add_(0, flat, (weights * labels).reshape(-1))
    wneg.index_add_(0, flat, (weights * (1.0 - labels)).reshape(-1))
    return torch.stack(
        [wpos.reshape(num_tasks, num_bins), wneg.reshape(num_tasks, num_bins)], dim=1
    )


def _prepare_scores(
    scores: torch.Tensor, bounds: Optional[Tuple[float, float]]
) -> torch.Tensor:
    """The plain path's score mapping to [0, 1]."""
    if bounds is None:
        return _normalize_scores(scores)
    return _rescale_fixed(scores, bounds)


def _histogram_plain_full(
    scores: torch.Tensor,
    labels: torch.Tensor,
    weights: Optional[torch.Tensor],
    num_bins: int,
    bounds: Optional[Tuple[float, float]],
) -> torch.Tensor:
    """The plain version of what the kernel computes on raw (T, n) scores:
    the score mapping, then ``_histogram_plain``."""
    if weights is None:
        weights = torch.ones_like(scores)
    return _histogram_plain(_prepare_scores(scores, bounds), labels, weights, num_bins)


# ------------------------------------------------------------------- kernel


def _row_stride(x: torch.Tensor) -> int:
    """Row stride of a (T, n) operand the kernel reads (0 for a row
    broadcast over tasks); samples must be unit-stride."""
    if x.stride(1) != 1 and x.shape[1] > 1:
        raise ValueError(
            "fused_auc_hist kernel needs unit stride along samples, got "
            f"strides {x.stride()}"
        )
    return x.stride(0)


def _unit_stride_rows(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    if x is not None and x.shape[1] > 1 and x.stride(1) != 1:
        return x.contiguous()
    return x


_GRID_CACHE: dict = {}


def _blocks_per_task(lib, device: torch.device, n: int, num_tasks: int,
                     num_bins: int, use_shared: bool) -> int:
    key = (device.index, num_bins, use_shared)
    cap = _GRID_CACHE.get(key)
    if cap is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        if use_shared:
            per_sm = lib.tev_fused_auc_hist_blocks_per_sm(num_bins, device.index)
            if per_sm <= 0:
                raise RuntimeError(
                    f"fused_auc_hist: no block of {2 * num_bins * 4} bytes of "
                    "shared memory fits on an SM"
                )
        else:
            per_sm = 8
        cap = sms * per_sm
        _GRID_CACHE[key] = cap
    per_block = _MIN_SAMPLES_PER_BLOCK
    if use_shared:
        per_block = max(per_block, num_bins // 2)
    want = -(-n // per_block)
    return max(1, min(want, max(1, cap // num_tasks)))


def _histogram_cuda(
    out: torch.Tensor,
    scores: torch.Tensor,
    labels: torch.Tensor,
    weights: Optional[torch.Tensor],
    num_bins: int,
    bounds: Optional[Tuple[float, float]],
) -> torch.Tensor:
    """Add the histogram of raw (T, n) scores into ``out`` (T, 2, num_bins)
    with the Hopper kernel, in place, and return ``out``.

    ``labels`` and ``weights`` are float32 (T, n), dense or broadcast
    along tasks (row stride 0); ``weights=None`` means unit weights. The
    kernel launches on the current stream; n == 0 launches nothing.
    """
    num_tasks, n = scores.shape
    dev = scores.device
    if dev.type != "cuda":
        raise ValueError(f"fused_auc_hist kernel needs CUDA tensors, got {dev}")
    operands = {"out": out, "scores": scores, "labels": labels}
    if weights is not None:
        operands["weights"] = weights
    for name, t in operands.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, scores on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(out.shape) != (num_tasks, 2, num_bins) or not out.is_contiguous():
        raise ValueError(
            f"out must be a contiguous ({num_tasks}, 2, {num_bins}) tensor, "
            f"got {tuple(out.shape)}"
        )
    if not scores.is_contiguous():
        raise ValueError("scores must be contiguous")
    for name in ("labels", "weights"):
        t = operands.get(name)
        if t is not None and tuple(t.shape) != (num_tasks, n):
            raise ValueError(f"{name} shape {tuple(t.shape)} != scores {(num_tasks, n)}")
    if not 2 <= num_bins < 2**24 or num_tasks > 65535:
        raise ValueError(
            f"fused_auc_hist kernel takes 2 <= num_bins < 2**24 and at most "
            f"65535 tasks, got num_bins={num_bins}, tasks={num_tasks}"
        )
    if n == 0:
        return out
    lib = _kernels.load("fused_auc_hist")
    use_shared = 2 * num_bins * 4 <= _SHARED_HIST_MAX_BYTES
    if bounds is None:
        task_lo, task_span = _task_lo_span(scores)
        task_lo, task_span = task_lo.contiguous(), task_span.contiguous()
        lo, inv_span, per_task = np.float32(0), np.float32(0), 1
        lo_ptr, span_ptr = task_lo.data_ptr(), task_span.data_ptr()
    else:
        lo, inv_span = _fixed_bounds(bounds)
        per_task, lo_ptr, span_ptr = 0, None, None
    blocks = _blocks_per_task(lib, dev, n, num_tasks, num_bins, use_shared)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.tev_fused_auc_hist(
        scores.data_ptr(),
        labels.data_ptr(),
        _row_stride(labels),
        weights.data_ptr() if weights is not None else None,
        _row_stride(weights) if weights is not None else 0,
        n,
        num_tasks,
        num_bins,
        per_task,
        ctypes.c_float(lo),
        ctypes.c_float(inv_span),
        lo_ptr,
        span_ptr,
        out.data_ptr(),
        int(use_shared),
        blocks,
        dev.index,
        stream,
    )
    _kernels.check(lib, code, "fused_auc_hist launch")
    _kernels.LAUNCHES["fused_auc_hist"] += 1
    return out


# ----------------------------------------------------------------- dispatch


def _histogram_into(
    out: torch.Tensor,
    scores: torch.Tensor,
    labels: torch.Tensor,
    weights: Optional[torch.Tensor],
    num_bins: int,
    bounds: Optional[Tuple[float, float]],
) -> torch.Tensor:
    """Add the batch histogram into ``out``: in place through the kernel
    for CUDA tensors, ``out + plain histogram`` for CPU tensors."""
    if scores.shape[-1] == 0:
        # zero samples -> zero histogram (the min/max has no identity)
        return out
    scores2, labels2, weights2 = _as_2d(scores, labels, weights)
    if scores2.is_cuda:
        return _histogram_cuda(
            out,
            scores2.contiguous(),
            _unit_stride_rows(labels2),
            _unit_stride_rows(weights2),
            num_bins,
            bounds,
        )
    return out + _histogram_plain_full(scores2, labels2, weights2, num_bins, bounds)


def histogram_delta_kernel(
    scores: torch.Tensor,
    labels: torch.Tensor,
    weights: Optional[torch.Tensor],
    num_bins: int,
    bounds: Optional[Tuple[float, float]],
) -> torch.Tensor:
    """Batch histogram for accumulate-style update plans
    (``hist += histogram(batch)``)."""
    num_tasks = 1 if scores.ndim == 1 else scores.shape[0]
    out = torch.zeros((num_tasks, 2, num_bins), dtype=torch.float32, device=scores.device)
    return _histogram_into(out, scores, labels, weights, num_bins, bounds)


def histogram_accumulate_kernel(
    states: Tuple[torch.Tensor],
    scores: torch.Tensor,
    labels: torch.Tensor,
    weights: Optional[torch.Tensor],
    num_bins: int,
    bounds: Tuple[float, float],
) -> Tuple[torch.Tensor]:
    """Transform-plan form of ``hist += histogram(batch)``: on CUDA the
    kernel adds straight into the state tensor in place (no batch
    histogram is materialized); on the CPU it returns a new tensor."""
    (hist,) = states
    return (_histogram_into(hist, scores, labels, weights, num_bins, bounds),)


def _check_bounds(
    bounds: Optional[Tuple[float, float]],
) -> Optional[Tuple[float, float]]:
    if bounds is None:
        return None
    lo, hi = float(bounds[0]), float(bounds[1])
    if not hi > lo:
        raise ValueError(f"bounds must satisfy hi > lo, got ({lo}, {hi}).")
    return lo, hi


def _inputs(input, target, weight, device):
    dev = functional_device(device, input, target, weight)
    scores = to_torch_float(input, device=dev)
    labels = to_torch(target, device=dev)
    weights = None if weight is None else to_torch_float(weight, device=dev)
    return scores, labels, weights


def fused_auc_histogram(
    input,
    target,
    weight=None,
    *,
    num_bins: int = DEFAULT_NUM_BINS,
    bounds: Optional[Tuple[float, float]] = None,
    device: DeviceLike = None,
) -> torch.Tensor:
    """(num_tasks, 2, num_bins) positive/negative weight histograms of the
    scores.

    ``bounds=None`` (default) min/max-normalizes the scores per call, per
    task: such a histogram is only valid for this call's data and must not
    be accumulated or merged across batches. Pass fixed ``(lo, hi)`` --
    e.g. ``(0.0, 1.0)`` for probabilities -- to fix the bin edges
    globally; out-of-range scores clamp into the edge bins.

    Runs where the tensor inputs live (numpy and scalars go to CUDA unless
    ``device="cpu"``): CUDA tensors through the Hopper kernel, CPU tensors
    through the plain version.
    """
    scores, labels, weights = _inputs(input, target, weight, device)
    return histogram_delta_kernel(
        scores, labels, weights, num_bins, _check_bounds(bounds)
    )


def fused_auc_histogram_accumulate(
    hist: torch.Tensor,
    input,
    target,
    weight=None,
    *,
    num_bins: int = DEFAULT_NUM_BINS,
    bounds: Tuple[float, float] = (0.0, 1.0),
) -> torch.Tensor:
    """``hist + histogram(batch)``, on ``hist``'s device. ``bounds`` is
    required (fixed bin edges are what make accumulation meaningful).

    On CUDA the kernel adds into ``hist`` IN PLACE and returns it; on the
    CPU a new tensor is returned and ``hist`` is left as it was.
    """
    if bounds is None:
        raise ValueError(
            "fused_auc_histogram_accumulate requires fixed bounds: with "
            "bounds=None each batch would be min/max-normalized to its own "
            "bin edges, and summing such histograms is meaningless."
        )
    scores, labels, weights = _inputs(input, target, weight, hist.device)
    return _histogram_into(
        hist, scores, labels, weights, num_bins, _check_bounds(bounds)
    )


def fused_auc(
    input,
    target,
    weight=None,
    *,
    num_bins: int = DEFAULT_NUM_BINS,
    bounds: Optional[Tuple[float, float]] = None,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Sort-free approximate AUROC, exact up to bin resolution. Shape
    (n,) -> scalar; (num_tasks, n) -> (num_tasks,).

    >>> import torch
    >>> from torcheval_tpu_torch.ops import fused_auc
    >>> fused_auc(torch.tensor([0.1, 0.5, 0.7, 0.8]), torch.tensor([0, 0, 1, 1]))
    tensor(1.)
    """
    scores, labels, weights = _inputs(input, target, weight, device)
    hist = histogram_delta_kernel(
        scores, labels, weights, num_bins, _check_bounds(bounds)
    )
    auc = _auc_from_hist(hist)
    return auc[0] if scores.ndim == 1 else auc
