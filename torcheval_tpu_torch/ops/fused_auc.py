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

from typing import Callable, Dict, NamedTuple, Optional, Tuple

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
    copied). An absent weight stays ``None``: unit weights are implicit.
    Each step is skipped where it would change nothing: this runs on every
    streaming update."""
    scores = _float32_rows(input)
    labels = _float32_rows(target)
    if labels.shape != scores.shape:
        labels = labels.expand(scores.shape)
    if weight is not None:
        weight = _float32_rows(weight)
        if weight.shape != scores.shape:
            weight = weight.expand(scores.shape)
    return scores, labels, weight


def _float32_rows(x: torch.Tensor) -> torch.Tensor:
    """``torch.atleast_2d(x).to(torch.float32)``, without the calls that
    would not change ``x``."""
    if x.ndim < 2:
        x = x.reshape(1, -1)
    return x if x.dtype == torch.float32 else x.to(torch.float32)


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

_THREADS = 512  # threads a CTA (kThreads in csrc/fused_auc_hist.cu)
# The switch points below come from chip_smoke.py's design sweep
# (`python3 chip_smoke.py --sweep`, PERF.md): T = 1, skewed and uniform
# scores, 65,536 to 2^24 samples, 8,192 and 65,536 bins.
#
# A histogram of up to this many bytes (2 * num_bins float32: 8,192 bins)
# is kept whole in every CTA ("replicated"), in clusters of
# _REPLICA_CLUSTER whose copies the flush sums over distributed shared
# memory; a cluster joins the task for every _CTA_SAMPLES samples a CTA
_REPLICA_MAX_BYTES = 64 * 1024
_REPLICA_CLUSTER = 8
_CTA_SAMPLES = 1 << 11
# A larger histogram is split over a cluster (C doubling from 2 until a
# CTA's slice, 2 * ceil(num_bins / C) float32, fits _SLICE_TARGET_BYTES),
# when the batch has at least _SPLIT_SAMPLES_PER_BIN samples a bin to pay
# for zeroing and flushing it; a smaller batch, or a slice past
# _SLICE_MAX_BYTES at C = 16 (num_bins > 204,800), takes the global-memory
# variant, a block for every _GLOBAL_BLOCK_SAMPLES samples
_SLICE_TARGET_BYTES = 64 * 1024
_SLICE_MAX_BYTES = 100 * 1024
_SPLIT_SAMPLES_PER_BIN = 16
_GLOBAL_BLOCK_SAMPLES = 1 << 8
_MAX_TASKS = 65535  # gridDim.y


class K1Geometry(NamedTuple):
    """One launch's shape: ``clusters_per_task`` clusters of ``cluster``
    CTAs for each task, each CTA with ``smem_bytes`` of shared memory:
    a whole copy of the task histogram (``split`` False) or its slice of
    it (``split`` True). ``smem_bytes`` 0 is the global-memory variant,
    where ``cluster`` is 1 and a "cluster" is one block."""

    cluster: int
    clusters_per_task: int
    smem_bytes: int
    split: bool = False

    @property
    def shared(self) -> bool:
        """The histogram in the cluster's shared memory (else the
        global-memory variant)."""
        return self.smem_bytes > 0

    @property
    def slots(self) -> int:
        """Bins a CTA holds: all of them (replicated), or those b with
        b % cluster == its rank, bin b at slot b // cluster (split)."""
        return self.smem_bytes // 8


def _slice_bytes(num_bins: int, cluster: int) -> int:
    return 2 * 4 * -(-num_bins // cluster)


def k1_geometry(
    n: int,
    num_tasks: int,
    num_bins: int,
    *,
    active_clusters: Callable[[int, int], int],
) -> K1Geometry:
    """The kernel's launch geometry for ``num_tasks`` rows of ``n``
    samples into ``num_bins`` bins.

    ``active_clusters(cluster, smem_bytes)`` is how many such clusters the
    card holds at once (for ``(1, 0)``: blocks of the global-memory
    variant); the wrapper queries it once per device and layout, a test
    passes a model of the card.

    - Layout: replicated up to ``_REPLICA_MAX_BYTES`` of histogram; else
      split when ``n`` reaches ``_SPLIT_SAMPLES_PER_BIN`` samples a bin and
      a slice fits ``_SLICE_MAX_BYTES``; else the global-memory variant.
    - Clusters a task: one for each ``cluster * _CTA_SAMPLES`` samples
      (``_GLOBAL_BLOCK_SAMPLES`` a block on the global variant), at most
      what fills the card with every task resident, at least one.
    """
    if not 2 <= num_bins < 2**24 or not 1 <= num_tasks <= _MAX_TASKS:
        raise ValueError(
            f"fused_auc_hist kernel takes 2 <= num_bins < 2**24 and 1 to "
            f"{_MAX_TASKS} tasks, got num_bins={num_bins}, tasks={num_tasks}"
        )
    split = 8 * num_bins > _REPLICA_MAX_BYTES
    if not split:
        cluster, smem = _REPLICA_CLUSTER, 8 * num_bins
    else:
        cluster = 2
        while cluster < 16 and _slice_bytes(num_bins, cluster) > _SLICE_TARGET_BYTES:
            cluster *= 2
        smem = _slice_bytes(num_bins, cluster)
    per = cluster * _CTA_SAMPLES
    if split and (smem > _SLICE_MAX_BYTES or n < _SPLIT_SAMPLES_PER_BIN * num_bins):
        cluster, smem, split, per = 1, 0, False, _GLOBAL_BLOCK_SAMPLES
    resident = active_clusters(cluster, smem)
    if resident < 1:
        raise RuntimeError(
            f"fused_auc_hist: no cluster of {cluster} CTAs with {smem} bytes "
            "of shared memory each can be scheduled on this device"
        )
    want = -(-max(n, 1) // per)
    return K1Geometry(cluster, max(1, min(want, resident // num_tasks)), smem, split)


_DEVICES: Dict[int, Callable[[int, int], int]] = {}
_GEOMETRY: Dict[tuple, K1Geometry] = {}
_BOUNDS: Dict[Tuple[float, float], Tuple[float, float]] = {}


def _device_occupancy(lib, device: int) -> Callable[[int, int], int]:
    """Set up the kernel on ``device`` (its function attributes, once) and
    return its ``active_clusters`` query, each answer cached."""
    query = _DEVICES.get(device)
    if query is not None:
        return query
    with torch.cuda.device(device):
        _kernels.check(lib, lib.tev_fused_auc_hist_init(_SLICE_MAX_BYTES),
                       "fused_auc_hist init")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
    answers: Dict[Tuple[int, int], int] = {}

    def active_clusters(cluster: int, smem_bytes: int) -> int:
        key = (cluster, smem_bytes)
        if key not in answers:
            with torch.cuda.device(device):
                if smem_bytes == 0:
                    got = sms * lib.tev_fused_auc_hist_global_blocks_per_sm()
                else:
                    got = lib.tev_fused_auc_hist_max_active_clusters(cluster, smem_bytes)
                    if got < 0:
                        _kernels.check(lib, -got, "fused_auc_hist occupancy query")
            answers[key] = got
        return answers[key]

    _DEVICES[device] = active_clusters
    return active_clusters


def _geometry(lib, device: int, n: int, num_tasks: int, num_bins: int) -> K1Geometry:
    key = (device, n, num_tasks, num_bins)
    geometry = _GEOMETRY.get(key)
    if geometry is None:
        if len(_GEOMETRY) > 4096:
            _GEOMETRY.clear()
        geometry = _GEOMETRY[key] = k1_geometry(
            n, num_tasks, num_bins, active_clusters=_device_occupancy(lib, device)
        )
    return geometry


def _bounds_f32(bounds: Tuple[float, float]) -> Tuple[float, float]:
    """``_fixed_bounds`` as Python floats (exact), cached per bounds."""
    got = _BOUNDS.get(bounds)
    if got is None:
        lo, inv_span = _fixed_bounds(bounds)
        got = _BOUNDS[bounds] = (float(lo), float(inv_span))
    return got


def _unit_stride_rows(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    if x is not None and x.shape[1] > 1 and x.stride(1) != 1:
        return x.contiguous()
    return x


def _check_out(out: torch.Tensor, scores: torch.Tensor, num_bins: int) -> None:
    if (
        out.dtype != torch.float32
        or out.shape != (scores.shape[0], 2, num_bins)
        or not out.is_contiguous()
    ):
        raise ValueError(
            f"out must be a contiguous float32 ({scores.shape[0]}, 2, "
            f"{num_bins}) tensor, got {out.dtype} {tuple(out.shape)}"
        )
    if out.get_device() != scores.get_device():
        raise ValueError(f"out is on {out.device}, scores on {scores.device}")


def _check_rows(name: str, x: torch.Tensor, scores: torch.Tensor) -> None:
    """A (T, n) operand the kernel reads beside ``scores``: float32, on its
    device, its shape, unit stride along samples (a row broadcast over
    tasks, row stride 0, is fine)."""
    if (
        x.dtype != torch.float32
        or x.get_device() != scores.get_device()
        or x.shape != scores.shape
        or (x.stride(1) != 1 and x.shape[1] > 1)
    ):
        raise ValueError(
            f"{name} must be float32 {tuple(scores.shape)} on {scores.device} "
            f"with unit stride along samples, got {x.dtype} "
            f"{tuple(x.shape)} strides {x.stride()} on {x.device}"
        )


def _histogram_cuda(
    out: torch.Tensor,
    scores: torch.Tensor,
    labels: torch.Tensor,
    weights: Optional[torch.Tensor],
    num_bins: int,
    bounds: Optional[Tuple[float, float]],
    geometry: Optional[K1Geometry] = None,
) -> torch.Tensor:
    """Add the histogram of raw (T, n) scores into ``out`` (T, 2, num_bins)
    with the Hopper kernel, in place, and return ``out``, every operand
    checked.

    ``scores`` is contiguous float32; ``labels`` and ``weights`` float32
    (T, n), dense or broadcast along tasks (row stride 0);
    ``weights=None`` means unit weights. The kernel launches on the current
    stream; n == 0 launches nothing. ``geometry`` overrides
    ``k1_geometry``'s choice.
    """
    if not scores.is_cuda:
        raise ValueError(f"fused_auc_hist kernel needs CUDA tensors, got {scores.device}")
    if scores.dtype != torch.float32 or not scores.is_contiguous():
        raise ValueError(f"scores must be contiguous float32, got {scores.dtype}")
    _check_out(out, scores, num_bins)
    _check_rows("labels", labels, scores)
    if weights is not None:
        _check_rows("weights", weights, scores)
    return _launch(out, scores, labels, weights, num_bins, bounds, geometry)


def _launch(
    out: torch.Tensor,
    scores: torch.Tensor,
    labels: torch.Tensor,
    weights: Optional[torch.Tensor],
    num_bins: int,
    bounds: Optional[Tuple[float, float]],
    geometry: Optional[K1Geometry] = None,
) -> torch.Tensor:
    """The launch, on operands as ``_histogram_cuda`` checks them; the bin
    and task counts are checked by ``k1_geometry``, once per shape."""
    num_tasks, n = scores.shape
    if n == 0:
        return out
    device = scores.get_device()
    if device != torch.cuda.current_device():
        with torch.cuda.device(device):
            return _launch(out, scores, labels, weights, num_bins, bounds, geometry)
    lib = _kernels.load("fused_auc_hist")
    if geometry is None:
        geometry = _geometry(lib, device, n, num_tasks, num_bins)
    task_bounds = None
    if bounds is None:
        task_lo, task_span = _task_lo_span(scores)
        task_bounds = (task_lo.contiguous(), task_span.contiguous())
    args = _pack_launch(out, scores, labels, weights, num_bins, bounds, geometry, task_bounds)
    code = lib.tev_fused_auc_hist(args, torch._C._cuda_getCurrentRawStream(device))
    if code:
        _kernels.check(lib, code, "fused_auc_hist launch")
    _kernels.count_launch("fused_auc_hist")
    return out


def _pack_launch(
    out: torch.Tensor,
    scores: torch.Tensor,
    labels: torch.Tensor,
    weights: Optional[torch.Tensor],
    num_bins: int,
    bounds: Optional[Tuple[float, float]],
    geometry: K1Geometry,
    task_bounds: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> bytes:
    """The kernel's ``K1Launch`` argument for these operands, packed in the
    C field order (``_kernels.K1_LAUNCH_FIELDS``): fixed ``bounds``, or,
    with ``bounds=None``, ``task_bounds`` = contiguous (T, 1) per-task
    minimum and span, which the caller keeps alive until the launch."""
    if bounds is None:
        task_lo, task_span = task_bounds
        per_task, lo, inv_span = 1, 0.0, 0.0
        lo_ptr, span_ptr = task_lo.data_ptr(), task_span.data_ptr()
    else:
        lo, inv_span = _bounds_f32(bounds)
        per_task, lo_ptr, span_ptr = 0, 0, 0
    num_tasks, n = scores.shape
    return _kernels.K1_LAUNCH.pack(
        scores.data_ptr(),
        labels.data_ptr(),
        0 if weights is None else weights.data_ptr(),
        lo_ptr,
        span_ptr,
        out.data_ptr(),
        labels.stride(0),
        0 if weights is None else weights.stride(0),
        n,
        num_tasks,
        num_bins,
        per_task,
        lo,
        inv_span,
        geometry.cluster,
        geometry.clusters_per_task,
        geometry.smem_bytes,
        geometry.split,
    )


# ------------------------------------------------------------- the K1 op

# The launch is registered as one dispatcher op that mutates ``out``: its
# CUDA kernel is ``_launch`` (the ctypes call above), its fake kernel does
# nothing. So a program traced on fake tensors (``analysis.program``) sees
# K1 as one op, as the JAX verifier sees one primitive for a
# ``pallas_call``, and a fake tensor never reaches ``data_ptr``.
# Registering a schema builds nothing: the library still builds on the
# first launch.
_K1_LIB = torch.library.Library("torcheval_tpu_torch", "FRAGMENT")
_K1_LIB.define(
    "fused_auc_hist_(Tensor(a!) out, Tensor scores, Tensor labels, "
    "Tensor? weights, int num_bins, float[]? bounds) -> ()"
)


def _launch_op(out, scores, labels, weights, num_bins, bounds) -> None:
    _launch(out, scores, labels, weights, num_bins, None if bounds is None else tuple(bounds))


def _launch_fake(out, scores, labels, weights, num_bins, bounds) -> None:
    return None


_K1_LIB.impl("fused_auc_hist_", _launch_op, "CUDA")
torch.library.register_fake("torcheval_tpu_torch::fused_auc_hist_", _launch_fake, lib=_K1_LIB)
K1_OP = torch.ops.torcheval_tpu_torch.fused_auc_hist_.default


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
    (the ``K1_OP`` dispatcher op) for CUDA tensors, ``out + plain
    histogram`` for CPU tensors.

    On CUDA only ``out`` is checked on every call: the entry points put
    every input on one device, and ``_as_2d``, ``contiguous`` and
    ``_unit_stride_rows`` make them float32 (T, n) rows the kernel reads,
    so ``_histogram_cuda``'s other checks cannot fail here."""
    if scores.shape[-1] == 0:
        # zero samples -> zero histogram (the min/max has no identity)
        return out
    scores2, labels2, weights2 = _as_2d(scores, labels, weights)
    if scores2.is_cuda:
        _check_out(out, scores2, num_bins)
        K1_OP(
            out,
            scores2.contiguous(),
            _unit_stride_rows(labels2),
            _unit_stride_rows(weights2),
            num_bins,
            bounds,
        )
        return out
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
