"""Streaming n-gram overlap: the O(1)-state BLEU precision core
(counterpart of ``torcheval_tpu/streaming/ngram.py``).

The metric carries a constant-size cache through the decode loop: the last
``n-1`` tokens of each stream (the n-gram "tail"), one ``(n, buckets)``
plane of hashed n-gram counts per side, and the running lengths. Each
decode step extends both tails, hashes every n-gram the new token
completes into its order's bucket row (``streaming._mix``), and moves on;
no token is stored beyond the tail window.

``finish()`` closes the in-flight stream pair: clipped matches are
``min(candidate_counts, reference_counts)`` summed per order (bucket-wise,
so a hash collision can shift credit between colliding n-grams), possible
counts come from the hypothesis length, and both fold into cumulative
corpus counters. ``compute()`` reads only the cumulative counters and
returns the BLEU-style geometric-mean precision with brevity penalty.

Every counter is int32 and the tokens fold one after another, so
token-by-token and whole-sequence feeding give the same counters. The
orders of one token hash as one vector: the fold runs over the window's
positions and order ``k`` absorbs the positions from ``n - k`` on, the
same chain of steps the JAX package folds order by order. Merging:
cumulative counters SUM; the in-flight plane merges exactly when at most
one rank has a stream open (tails merge by MAX over the ``-1`` "empty"
sentinel); the keyed many-request regime is ``table.StreamTable``.
"""

from __future__ import annotations

from typing import NamedTuple, TypeVar

import torch

from torcheval_tpu_torch.metrics.metric import MergeKind, Metric, UpdatePlan
from torcheval_tpu_torch.streaming._mix import MIX_SEED, mix_step
from torcheval_tpu_torch.streaming.edit import _aligned_tokens
from torcheval_tpu_torch.utils.convert import DeviceLike

TStreamingNgramOverlap = TypeVar("TStreamingNgramOverlap", bound="StreamingNgramOverlap")

__all__ = ["NgramOverlap", "StreamingNgramOverlap"]

_INFLIGHT_STATES = (
    "cand_counts",
    "ref_counts",
    "hyp_tail",
    "ref_tail",
    "hyp_len",
    "ref_len",
)


class NgramOverlap(NamedTuple):
    """``StreamingNgramOverlap.compute()`` result (tensors)."""

    overlap: torch.Tensor
    brevity_penalty: torch.Tensor
    precision_by_order: torch.Tensor
    matches_by_order: torch.Tensor
    possible_by_order: torch.Tensor
    hyp_len_total: torch.Tensor
    ref_len_total: torch.Tensor
    num_sequences: torch.Tensor


def _fold_token(counts, tail, length, tok, n_gram: int, buckets: int):
    """Absorb one (possibly ``-1``) token into one side's state; ``counts``
    is written in place."""
    device = counts.device
    valid = tok >= 0
    new_len = length + valid.to(torch.int32)
    window = torch.cat([tail, tok.reshape(1)]) if n_gram > 1 else tok.reshape(1)
    # order k = n_gram - j0 absorbs positions j0..n_gram-1: one hash a order
    starts = torch.arange(n_gram - 1, -1, -1, device=device)  # order 1..n
    h = torch.full((n_gram,), MIX_SEED, dtype=torch.int64, device=device)
    for j in range(n_gram):
        h = torch.where(starts <= j, mix_step(h, window[j]), h)
    orders = torch.arange(1, n_gram + 1, device=device)
    cell = (orders - 1) * buckets + (h & (buckets - 1))
    hit = valid & (new_len >= orders)
    counts.view(-1).index_add_(0, cell, hit.to(torch.int32))
    if n_gram > 1:
        shifted = torch.cat([tail[1:], tok.reshape(1)])
        tail = torch.where(valid, shifted, tail)
    return counts, tail, new_len


_UPDATE_KERNELS: dict = {}


def _ngram_update_kernel(n_gram: int, buckets: int, masked: bool):
    key = (n_gram, buckets, masked)
    fn = _UPDATE_KERNELS.get(key)
    if fn is not None:
        return fn

    def kernel(states, hyp, ref, *rest):
        cand, refc, htail, rtail, hlen, rlen = states
        for i in range(hyp.shape[0]):
            ht, rt = hyp[i], ref[i]
            if masked:
                # padded steps become the -1 sentinel: an exact no-op
                live = i < rest[0][0]
                ht = torch.where(live, ht, -1)
                rt = torch.where(live, rt, -1)
            cand, htail, hlen = _fold_token(cand, htail, hlen, ht, n_gram, buckets)
            refc, rtail, rlen = _fold_token(refc, rtail, rlen, rt, n_gram, buckets)
        return cand, refc, htail, rtail, hlen, rlen

    _UPDATE_KERNELS[key] = kernel
    return kernel


def _sum_orders(x: torch.Tensor) -> torch.Tensor:
    """Sum over the leading (order) axis as a left fold: the same float
    adds for one stream's vector and a table's ``(n, keys)`` columns, on
    any device (a reduction kernel's order depends on the shape)."""
    out = x[0]
    for i in range(1, x.shape[0]):
        out = out + x[i]
    return out


def _ngram_compute(matches, possible, hyp_total, ref_total, num_seq) -> NgramOverlap:
    m = matches.to(torch.float32)
    p = possible.to(torch.float32)
    used = p > 0
    safe_p = torch.where(used, p, 1.0)
    precision = torch.where(used, m / safe_p, 0.0)
    log_prec = torch.where(used & (m > 0), torch.log(torch.where(m > 0, m, 1.0) / safe_p), 0.0)
    n_used = torch.sum(used.to(torch.float32))
    geo = torch.exp(_sum_orders(log_prec) / torch.clamp(n_used, min=1.0))
    # any used order with zero matches zeroes the geometric mean, as in BLEU
    geo = torch.where(torch.any(used & (m == 0)) | (n_used == 0), 0.0, geo)
    h = hyp_total.to(torch.float32)
    r = ref_total.to(torch.float32)
    bp = torch.where(h >= r, 1.0, torch.exp(1.0 - r / torch.where(h > 0, h, 1.0)))
    bp = torch.where(h > 0, bp, 0.0)
    overlap = torch.where(num_seq > 0, geo * bp, 0.0)
    return NgramOverlap(
        overlap=overlap,
        brevity_penalty=bp,
        precision_by_order=precision,
        matches_by_order=matches,
        possible_by_order=possible,
        hyp_len_total=hyp_total,
        ref_len_total=ref_total,
        num_sequences=num_seq,
    )


class StreamingNgramOverlap(Metric[NgramOverlap]):
    """Corpus-level clipped n-gram precision over token streams.

    One in-flight hypothesis/reference stream pair at a time: feed decode
    steps with ``update``, close the pair with ``finish()``, repeat for the
    next sequence. Token ids must be non-negative; ``-1`` means "no token
    on this side at this step".

    Args:
        n_gram: maximum n-gram order (default 4, as in BLEU-4).
        buckets: hashed count-plane width per order; a power of two.
        device: where the state lives (CUDA by default).

    >>> from torcheval_tpu_torch.streaming import StreamingNgramOverlap
    >>> metric = StreamingNgramOverlap(n_gram=2, device="cpu")
    >>> for hyp, ref in [(1, 1), (2, 2), (7, 3)]:
    ...     _ = metric.update(hyp, ref)
    >>> _ = metric.finish()
    >>> round(float(metric.compute().overlap), 4)
    0.5774
    """

    _bucketed_update = True

    def __init__(self, *, n_gram: int = 4, buckets: int = 128, device: DeviceLike = None) -> None:
        super().__init__(device=device)
        if n_gram < 1:
            raise ValueError(f"n_gram must be >= 1, got {n_gram}")
        if buckets < 1 or (buckets & (buckets - 1)) != 0:
            raise ValueError(f"buckets must be a power of two, got {buckets}")
        self.n_gram = int(n_gram)
        self.buckets = int(buckets)

        def zeros(shape):
            return torch.zeros(shape, dtype=torch.int32)

        # cumulative (finished-streams) counters: plain distributive sums
        self._add_state("matches_by_order", zeros((n_gram,)), merge=MergeKind.SUM)
        self._add_state("possible_by_order", zeros((n_gram,)), merge=MergeKind.SUM)
        self._add_state("hyp_len_total", zeros(()), merge=MergeKind.SUM)
        self._add_state("ref_len_total", zeros(()), merge=MergeKind.SUM)
        self._add_state("num_sequences", zeros(()), merge=MergeKind.SUM)
        # in-flight stream state, O(1) in sequence length
        self._add_state("cand_counts", zeros((n_gram, buckets)), merge=MergeKind.SUM)
        self._add_state("ref_counts", zeros((n_gram, buckets)), merge=MergeKind.SUM)
        tail = torch.full((n_gram - 1,), -1, dtype=torch.int32)
        self._add_state("hyp_tail", tail, merge=MergeKind.MAX)
        self._add_state("ref_tail", tail, merge=MergeKind.MAX)
        self._add_state("hyp_len", zeros(()), merge=MergeKind.SUM)
        self._add_state("ref_len", zeros(()), merge=MergeKind.SUM)

    def update(self: TStreamingNgramOverlap, step_tokens, ref_tokens=None) -> TStreamingNgramOverlap:
        """Fold one decode step into the in-flight stream pair.

        Args:
            step_tokens: hypothesis token id(s), scalar or 1-D; ``-1`` where
                the hypothesis emitted nothing.
            ref_tokens: reference token id(s) for the same step(s), or
                ``None`` when the reference emits nothing here.
        """
        return self._apply_update_plan(self._update_plan(step_tokens, ref_tokens))

    def _update_plan(self, step_tokens, ref_tokens=None):
        hyp, ref = _aligned_tokens(self, step_tokens, ref_tokens, "cover the same steps")
        return UpdatePlan(
            _ngram_update_kernel(self.n_gram, self.buckets, False),
            _INFLIGHT_STATES,
            (hyp, ref),
            transform=True,
            masked_kernel=_ngram_update_kernel(self.n_gram, self.buckets, True),
            batch_axes=(("n",), ("n",)),
        )

    def finish(self: TStreamingNgramOverlap) -> TStreamingNgramOverlap:
        """Close the in-flight stream pair and fold its clipped matches into
        the cumulative counters. No-op when nothing is in flight (checked
        on the host, so an idle ``finish`` launches nothing)."""
        if int(self.hyp_len) == 0 and int(self.ref_len) == 0:
            return self
        clipped = torch.sum(torch.minimum(self.cand_counts, self.ref_counts), dim=1, dtype=torch.int32)
        orders = torch.arange(1, self.n_gram + 1, dtype=torch.int32, device=self.device)
        possible = torch.clamp(self.hyp_len - orders + 1, min=0)
        self.matches_by_order = self.matches_by_order + clipped
        self.possible_by_order = self.possible_by_order + possible
        self.hyp_len_total = self.hyp_len_total + self.hyp_len
        self.ref_len_total = self.ref_len_total + self.ref_len
        self.num_sequences = self.num_sequences + 1
        self.cand_counts = torch.zeros_like(self.cand_counts)
        self.ref_counts = torch.zeros_like(self.ref_counts)
        self.hyp_len = torch.zeros_like(self.hyp_len)
        self.ref_len = torch.zeros_like(self.ref_len)
        tail = torch.full((self.n_gram - 1,), -1, dtype=torch.int32, device=self.device)
        self.hyp_tail = tail
        self.ref_tail = tail.clone()
        return self

    def compute(self) -> NgramOverlap:
        """BLEU-style overlap over all FINISHED streams (in-flight state
        contributes after its ``finish()``)."""
        return _ngram_compute(
            self.matches_by_order,
            self.possible_by_order,
            self.hyp_len_total,
            self.ref_len_total,
            self.num_sequences,
        )
