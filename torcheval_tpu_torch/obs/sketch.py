"""Mergeable input-distribution sketches (data-quality telemetry).

Counterpart of ``torcheval_tpu/obs/sketch.py`` with the same names, state
names, dtypes and merge kinds. :class:`InputSketch` is an ordinary
:class:`~torcheval_tpu_torch.metrics.metric.Metric`, so sync, merge,
elastic snapshots and shape bucketing apply to it unchanged. Its four
state families:

- ``hist`` (float32 ``(num_bins,)``, SUM): a log2 histogram of ``|x|`` by
  integer exponent (the default), or a fixed-edge histogram over
  ``bounds=(lo, hi)`` through ``ops.histogram``. Counts are
  integer-valued float32, exact below 2^24 a bin.
- ``counts`` (int32 ``(8,)``, SUM): total / NaN / +Inf / -Inf / zero /
  negative / below-range / above-range.
- ``moments`` (float32 ``(5,)``, CUSTOM): ``[count, mean, M2, min, max]``
  over the finite samples, each batch folded in with Chan's parallel
  merge (:func:`chan_merge`), whose empty-side identities are exact, so
  a rank-ordered left fold over carriers that partition a stream replays
  the single stream's fold bitwise.
- ``registers`` (int32 ``(registers,)``, MAX): a HyperLogLog-family
  distinct-count sketch over the raw float32 bit patterns, hashed with
  murmur3's finalizer (:func:`_fmix32`), the same placement on every rank.

**The fold.** The JAX package folds a batch with a C++ kernel on the CPU
(``ops/native/sketch.cc``) and an XLA twin elsewhere; neither is a TPU
kernel, so here it is one plain torch function, :func:`_sketch_fold`, on
every device. Its counter, histogram and register lanes are integer
arithmetic and equal the JAX package's bitwise. uint32 arithmetic runs in
int64 masked to 32 bits (the murmur3 multiplies split into 16-bit halves,
so no product leaves int64), and a bit length is the exponent of the
exact ``frexp`` of the value in float64. The moments are float sums:
the JAX package sums sequentially in float32, torch's reductions are
not sequential, so the batch moments differ from the JAX package's in
the last bits (the tests state the tolerance).

Nothing here reads the device on the update path; ``compute()``,
``summary`` reads and drift scoring read the small states back, at scrape
cadence.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from torcheval_tpu_torch.metrics.metric import MergeKind, Metric, UpdatePlan
from torcheval_tpu_torch.ops.histogram import histogram as _ops_histogram
from torcheval_tpu_torch.ops.segment import segment_max as _segment_max
from torcheval_tpu_torch.ops.segment import segment_sum as _segment_sum
from torcheval_tpu_torch.utils.convert import DeviceLike

__all__ = [
    "InputSketch",
    "SketchConfig",
    "SketchSummary",
    "chan_merge",
    "hll_estimate",
]

# counts lanes (int32 (8,) SUM state)
_CNT_TOTAL = 0
_CNT_NAN = 1
_CNT_POSINF = 2
_CNT_NEGINF = 3
_CNT_ZERO = 4
_CNT_NEG = 5
_CNT_BELOW = 6
_CNT_ABOVE = 7

CNT_FIELDS = (
    "total", "nan", "posinf", "neginf", "zero", "negative", "below", "above",
)

_MASK32 = 0xFFFFFFFF


class SketchConfig(NamedTuple):
    """Hashable sketch geometry. ``log2=True`` bins ``log2(|x|)`` by
    integer exponent over ``lo..hi``; ``log2=False`` bins values over
    fixed edges ``lo..hi`` in ``num_bins`` equal bins. ``registers`` is
    the distinct-sketch register count (a power of two)."""

    num_bins: int
    lo: float
    hi: float
    log2: bool
    registers: int

    @property
    def reg_bits(self) -> int:
        return int(self.registers).bit_length() - 1

    def edges(self) -> np.ndarray:
        """The ``num_bins + 1`` bin edges in VALUE space (log2 mode:
        ``2**exponent`` edges of ``|x|``)."""
        e = np.linspace(self.lo, self.hi, self.num_bins + 1)
        return np.exp2(e) if self.log2 else e


class SketchSummary(NamedTuple):
    """``InputSketch.compute()`` result (host floats)."""

    count: float        # finite samples folded into the moments
    mean: float
    var: float          # population variance (M2 / count)
    min: float
    max: float
    total: int          # every observed sample (NaN/Inf included)
    nan: int
    posinf: int
    neginf: int
    zero: int
    negative: int
    below: int          # finite (non-zero in log2 mode) under the range
    above: int
    distinct: float     # register-array estimate over raw bit patterns
    hist: Any           # (num_bins,) float32 counts (np.ndarray)


def default_config(
    num_bins: Optional[int] = None,
    bounds: Optional[Tuple[float, float]] = None,
    log2_bounds: Tuple[int, int] = (-24, 24),
    registers: int = 64,
) -> SketchConfig:
    """The user-facing knobs as a :class:`SketchConfig`: ``bounds=(lo,
    hi)`` is fixed-edge mode (``num_bins`` defaults to 32); without it,
    log2 mode over integer exponents ``log2_bounds``, one bin an exponent
    (zeros are counted apart, never binned)."""
    registers = int(registers)
    if registers < 16 or registers & (registers - 1):
        raise ValueError(f"registers must be a power of two >= 16, got {registers}")
    if bounds is not None:
        lo, hi = float(bounds[0]), float(bounds[1])
        if not hi > lo:
            raise ValueError(f"bounds must satisfy hi > lo, got ({lo}, {hi})")
        bins = 32 if num_bins is None else int(num_bins)
        if bins < 1:
            raise ValueError(f"num_bins must be >= 1, got {bins}")
        return SketchConfig(bins, lo, hi, False, registers)
    lo_e, hi_e = int(log2_bounds[0]), int(log2_bounds[1])
    if not hi_e > lo_e:
        raise ValueError(f"log2_bounds must satisfy hi > lo, got ({lo_e}, {hi_e})")
    bins = (hi_e - lo_e) if num_bins is None else int(num_bins)
    if bins != hi_e - lo_e:
        raise ValueError(
            "log2 mode bins values by INTEGER exponent — one bin per "
            f"exponent (num_bins == hi - lo == {hi_e - lo_e}); widen "
            "log2_bounds or use fixed-edge mode (bounds=) for custom "
            "bin counts"
        )
    return SketchConfig(bins, float(lo_e), float(hi_e), True, registers)


# ------------------------------------------------------------ fold kernels


def _bits(x: torch.Tensor) -> torch.Tensor:
    """The float32 bit patterns of ``x`` as uint32 values in int64."""
    return x.contiguous().view(torch.int32).to(torch.int64) & _MASK32


def _bit_length(v: torch.Tensor) -> torch.Tensor:
    """Bit length of non-negative int64 values below 2^32: the exponent of
    an exact float32 ``frexp`` (0 for 0). A value of 2^24 or more is
    shifted right by 8 first, so what is converted stays below 2^24,
    where float32 holds every integer exactly (no float64 on the update
    path)."""
    shift = (v >= (1 << 24)).to(torch.int64) * 8
    return torch.frexp((v >> shift).to(torch.float32))[1].to(torch.int64) + shift


def _clz32(v: torch.Tensor) -> torch.Tensor:
    """Count-leading-zeros of uint32 values held in int64."""
    return 32 - _bit_length(v)


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h * c mod 2^32`` for uint32 values in int64, in 16-bit halves so
    no product leaves int64."""
    lo, hi = h & 0xFFFF, h >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _MASK32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer over uint32 values held in int64: a
    deterministic, well-mixed hash of the raw value bits."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def chan_merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Chan's parallel moments merge of two ``[count, mean, M2, min, max]``
    float32 vectors (Chan, Golub & LeVeque 1979), with EXACT empty-side
    identities: a zero-count side returns the other side's bits. The
    update folds state with batch, the merge carrier with carrier in
    ascending rank order, both through this function. Element-wise, in
    the JAX package's operation order, each multiply and add rounded
    apart: bitwise equal to the JAX package's as its tests run it
    (``--xla_backend_optimization_level=0``). At XLA's default level the
    CPU backend contracts ``a + delta * q`` and ``s + delta² * r`` into
    fused multiply-adds, and those two lanes then differ by an ulp."""
    a = torch.as_tensor(a, dtype=torch.float32)
    b = torch.as_tensor(b, dtype=torch.float32, device=a.device)
    na, nb = a[0], b[0]
    n = na + nb
    safe_n = torch.clamp(n, min=1.0)
    delta = b[1] - a[1]
    mean = a[1] + delta * (nb / safe_n)
    m2 = a[2] + b[2] + delta * delta * (na * (nb / safe_n))
    mean = torch.where(na == 0, b[1], torch.where(nb == 0, a[1], mean))
    m2 = torch.where(na == 0, b[2], torch.where(nb == 0, a[2], m2))
    return torch.stack([n, mean, m2, torch.minimum(a[3], b[3]), torch.maximum(a[4], b[4])])


def moments_window(live: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """The exact inverse of :func:`chan_merge`: ``[count, mean, M2, min,
    max]`` of the samples folded AFTER ``ref`` was snapshotted from the
    same stream (drift scores the post-freeze window). min/max cannot be
    un-merged; the live extrema are returned."""
    live = np.asarray(live, np.float64)
    ref = np.asarray(ref, np.float64)
    n_w = live[0] - ref[0]
    if n_w <= 0:
        return np.asarray([0.0, 0.0, 0.0, live[3], live[4]], np.float64)
    mean_w = (live[0] * live[1] - ref[0] * ref[1]) / n_w
    delta = mean_w - ref[1]
    m2_w = live[2] - ref[2] - delta * delta * ref[0] * n_w / max(live[0], 1.0)
    return np.asarray([n_w, mean_w, max(m2_w, 0.0), live[3], live[4]], np.float64)


def _exponent_of(x: torch.Tensor) -> torch.Tensor:
    """``floor(log2(|x|))`` from the float32 bit pattern (int64): the
    unbiased exponent of a normal, ``bit_length(mantissa) - 150`` of a
    subnormal. Callers mask zeros and non-finites out."""
    mag = _bits(x) & 0x7FFFFFFF
    eb = mag >> 23
    sub = _bit_length(mag) - 1 - 149
    return torch.where(eb > 0, eb - 127, sub)


def _sketch_fold(cfg: SketchConfig, x: torch.Tensor, w: torch.Tensor):
    """One batch's sketch deltas ``(hist, counts, stats, regs)`` of flat
    float32 ``x`` under per-element float32 weights ``w`` (0 drops an
    element: bucket padding and masks fold in here). The anomaly lanes
    test bit patterns, not float compares, as the JAX package does."""
    bits = _bits(x)
    mag = bits & 0x7FFFFFFF
    sign = (bits >> 31) != 0
    is_nan = mag > 0x7F800000
    is_inf = mag == 0x7F800000
    finite = mag < 0x7F800000
    is_zero = finite & (mag == 0)
    nonzero = finite & (mag != 0)
    present = w > 0  # counter presence
    wf = w * finite.to(torch.float32)  # moment / histogram weights

    if cfg.log2:
        e = _exponent_of(x)
        below = nonzero & (e < int(cfg.lo))
        above = nonzero & (e >= int(cfg.hi))
    else:
        lo32, hi32 = float(np.float32(cfg.lo)), float(np.float32(cfg.hi))
        below = finite & (x < lo32)
        above = finite & (x > hi32)
    lanes = torch.stack(
        [
            present,
            present & is_nan,
            present & is_inf & ~sign,
            present & is_inf & sign,
            present & is_zero,
            present & nonzero & sign,
            present & below,
            present & above,
        ]
    )
    delta_counts = lanes.sum(dim=1, dtype=torch.int64).to(torch.int32)

    if cfg.log2:
        ids = torch.where(nonzero & ~below & ~above, e - int(cfg.lo), torch.full_like(e, -1))
        delta_hist = _segment_sum(wf, ids, cfg.num_bins)
    else:
        delta_hist = _ops_histogram(x, cfg.num_bins, bounds=(cfg.lo, cfg.hi), weights=wf)

    # streaming moments: two-pass batch stats
    used = wf > 0
    zero = torch.zeros_like(x)
    xz = torch.where(used, x, zero)
    bc = wf.sum()
    bmean = (xz * wf).sum() / torch.clamp(bc, min=1.0)
    bm2 = (wf * torch.square(torch.where(used, x - bmean, zero))).sum()
    bmin = torch.where(used, x, torch.full_like(x, math.inf)).amin() if x.numel() else bc.new_tensor(math.inf)
    bmax = torch.where(used, x, torch.full_like(x, -math.inf)).amax() if x.numel() else bc.new_tensor(-math.inf)
    stats = torch.stack([bc, bmean, bm2, bmin, bmax])

    # distinct-count registers over the raw bit patterns
    h = _fmix32(bits)
    j = h & (cfg.registers - 1)
    p = cfg.reg_bits
    rho = _clz32(h >> p) - p + 1
    rho = torch.where(present, rho, torch.zeros_like(rho))
    delta_reg = _segment_max(rho, j, cfg.registers, identity=0)
    return delta_hist, delta_counts, stats, delta_reg


def _fold(cfg: SketchConfig, states, x, w):
    """``fold(states4, x, w) -> states4`` with ``states4 = (hist, counts,
    moments, registers)``; ``w`` broadcasts over ``x``."""
    hist, counts, moments, registers = states
    x = x.to(torch.float32)
    w = torch.as_tensor(w, dtype=torch.float32, device=x.device).expand_as(x)
    delta_hist, delta_counts, stats, delta_reg = _sketch_fold(cfg, x.reshape(-1), w.reshape(-1))
    return (
        hist + delta_hist,
        counts + delta_counts,
        chan_merge(moments, stats),
        torch.maximum(registers, delta_reg),
    )


def _row_weights(x: torch.Tensor, valid_n) -> torch.Tensor:
    """Per-element float32 weights of a bucket-padded batch: 1 for the
    first ``valid_n`` rows (a device tensor), 0 for the padding."""
    n = x.shape[0]
    row = (torch.arange(n, device=x.device) < valid_n).to(torch.float32)
    return row.reshape((n,) + (1,) * (x.ndim - 1)).expand(x.shape)


@lru_cache(maxsize=None)
def _sketch_kernels(cfg: SketchConfig):
    """(plain, masked) transform kernels of :class:`InputSketch`'s update
    plan; the masked twin rebuilds the row mask from the valid vector, so
    padded rows contribute exactly zero."""

    def plain(states, x):
        return _fold(cfg, states, x, torch.ones((), dtype=torch.float32, device=x.device))

    def masked(states, x, valid):
        return _fold(cfg, states, x, _row_weights(x, valid[0]))

    plain.__name__ = f"sketch_fold_{cfg.num_bins}"
    masked.__name__ = f"sketch_fold_masked_{cfg.num_bins}"
    return plain, masked


@lru_cache(maxsize=None)
def _weighted_kernel(cfg: SketchConfig):
    def weighted(states, x, w):
        return _fold(cfg, states, x, w)

    weighted.__name__ = f"sketch_fold_weighted_{cfg.num_bins}"
    return weighted


def moment_default() -> torch.Tensor:
    """The empty moments vector: zero count/mean/M2, inverted extrema (the
    exact identity of :func:`chan_merge`)."""
    return torch.tensor([0.0, 0.0, 0.0, math.inf, -math.inf], dtype=torch.float32)


def hll_estimate(registers: np.ndarray) -> float:
    """The register-array cardinality estimate (HyperLogLog with the
    small-range linear-counting correction), host math over an int32
    register snapshot."""
    regs = np.asarray(registers, np.float64)
    m = regs.size
    if m == 0:
        return 0.0
    alpha = {16: 0.673, 32: 0.697, 64: 0.709}.get(m, 0.7213 / (1 + 1.079 / m))
    est = alpha * m * m / float(np.sum(np.exp2(-regs)))
    zeros = int(np.sum(regs == 0))
    if est <= 2.5 * m and zeros > 0:
        return m * math.log(m / zeros)
    return float(est)


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


class InputSketch(Metric[SketchSummary]):
    """Fixed-size mergeable distribution sketch of a value stream (the
    module docstring has the state families). ``update(values)`` flattens
    any tensor; ``weights`` (same shape) down-weights or masks elements.

    >>> import torch
    >>> from torcheval_tpu_torch.obs import InputSketch
    >>> sk = InputSketch(bounds=(0.0, 1.0), num_bins=4, device="cpu")
    >>> _ = sk.update(torch.tensor([0.1, 0.2, 0.6, 0.9]))
    >>> int(sk.compute().count)
    4
    """

    def __init__(
        self,
        *,
        num_bins: Optional[int] = None,
        bounds: Optional[Tuple[float, float]] = None,
        log2_bounds: Tuple[int, int] = (-24, 24),
        registers: int = 64,
        device: DeviceLike = None,
    ) -> None:
        super().__init__(device=device)
        self.config = default_config(num_bins, bounds, log2_bounds, registers)
        cfg = self.config
        self._add_state("hist", torch.zeros((cfg.num_bins,), dtype=torch.float32), merge=MergeKind.SUM)
        self._add_state("counts", torch.zeros((8,), dtype=torch.int32), merge=MergeKind.SUM)
        self._add_state("moments", moment_default(), merge=MergeKind.CUSTOM)
        self._add_state(
            "registers", torch.zeros((cfg.registers,), dtype=torch.int32), merge=MergeKind.MAX
        )

    def _update_plan(self, values, weights=None):
        values = self._input(values, dtype=torch.float32)
        plain, masked = _sketch_kernels(self.config)
        if weights is not None:
            weights = self._input(weights, dtype=torch.float32)
            if weights.shape != values.shape:
                raise ValueError(
                    f"weights shape {tuple(weights.shape)} != values {tuple(values.shape)}"
                )
            # weighted updates skip bucketing (the weight IS the mask)
            return UpdatePlan(
                _weighted_kernel(self.config),
                ("hist", "counts", "moments", "registers"),
                (values, weights),
                transform=True,
            )
        return UpdatePlan(
            plain,
            ("hist", "counts", "moments", "registers"),
            (values,),
            transform=True,
            masked_kernel=masked,
            batch_axes=(("batch",),),
        )

    def update(self, values, weights=None) -> "InputSketch":
        return self._apply_update_plan(self._update_plan(values, weights))

    def _merge_custom_state(self, name, mine, theirs):
        if name == "moments":
            # the merge loop left-folds peers in order: Chan's merge,
            # pairwise in carrier (ascending rank) order
            return chan_merge(mine, theirs)
        return super()._merge_custom_state(name, mine, theirs)

    def edges(self) -> np.ndarray:
        """Histogram bin edges in value space (log2 mode: ``|x|`` edges)."""
        return self.config.edges()

    def compute(self) -> SketchSummary:
        """Host-readable summary (reads the states back: scrape cadence,
        never the step path)."""
        mom = _host(self.moments).astype(np.float64)
        cnt = _host(self.counts)
        count = float(mom[0])
        return SketchSummary(
            count=count,
            mean=float(mom[1]) if count else 0.0,
            var=float(mom[2] / count) if count else 0.0,
            min=float(mom[3]),
            max=float(mom[4]),
            total=int(cnt[_CNT_TOTAL]),
            nan=int(cnt[_CNT_NAN]),
            posinf=int(cnt[_CNT_POSINF]),
            neginf=int(cnt[_CNT_NEGINF]),
            zero=int(cnt[_CNT_ZERO]),
            negative=int(cnt[_CNT_NEG]),
            below=int(cnt[_CNT_BELOW]),
            above=int(cnt[_CNT_ABOVE]),
            distinct=hll_estimate(_host(self.registers)),
            hist=_host(self.hist),
        )

    def quantile(self, q: float) -> Optional[float]:
        """Approximate q-quantile from the histogram: the upper edge of the
        bin holding the target sample (never under-reports; within one bin
        of the truth). ``None`` while the histogram is empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        counts = _host(self.hist).astype(np.float64)
        total = float(counts.sum())
        if total <= 0:
            return None
        edges = self.edges()
        target = max(1.0, math.ceil(q * total))
        seen = 0.0
        for i, c in enumerate(counts):
            seen += float(c)
            if seen >= target:
                return float(edges[i + 1])
        return float(edges[-1])
