"""StreamTable: per-request streaming quality keyed by request id
(counterpart of ``torcheval_tpu/table/streaming.py``).

The serving-side face of ``torcheval_tpu_torch.streaming``: where the
standalone streaming metrics carry ONE stream pair, a decode server
carries thousands concurrently. :class:`StreamTable` keys each stream by
its request id through the :class:`~torcheval_tpu_torch.table.MetricTable`
machinery — one device ingest per decode batch
(``ingest(request_ids, step_tokens=..., logprobs=...)``) resolves the
active requests to slots and accumulates every member family's O(1)
per-request state in-kernel; ``finish(request_ids)`` retires completed
requests, committing their finals into cumulative distribution sketches
at the next drain and evicting the slots through the existing drain
path. Everything a table does — hash partitioning, outbox sync,
admission shedding (decode rows carry HT weights like any intake),
TTL eviction, elastic resume — applies unchanged, because a StreamTable IS a :class:`TablePanel` over
streaming member families.

Member families (also registered standalone, so
``MetricTable("stream_logprob")`` works and ``obs.watch_inputs`` can
watch the logprob stream positionally on a single-family table):

- ``logprob`` — per-request NLL sum + token count; per-key value is the
  request's running perplexity (readable mid-flight).
- ``token_edit`` / ``token_accuracy`` — the positional WER/CER counters
  of ``streaming.edit`` at per-request grain (shared row kernel: both
  aliases ride one program); per-key value is the error rate / accuracy.
- ``ngram`` — the ``streaming.ngram`` BLEU precision core. The bounded
  tails and hashed count planes live in a HOST-side per-request mirror
  on the observing rank (they are not linear accumulators, so they
  cannot ride the segment-sum columns); the device columns receive the
  CLIPPED FINALS at ``finish`` in one commit row, and the per-key value
  is the request's overlap score once finished (0.0 in flight).

Shape discipline: ``ingest`` is the bucketed front door, and an EMPTY
request batch is a host-side no-op, so on CUDA a warmed StreamTable
processes any (batch, active-set) raggedness with ZERO new CUDA-graph
captures (counted by ``utils.CompileCounter``).

The ``ngram`` member's mirror is Python on the host: its cost is host
time a decode row (``_observe_step``), by design.

Bit-identity: per-request logprob/token_edit column folds follow the
table's rank-ordered outbox fold, and one row per request per batch (the
decode regime) makes the keyed fold the same float-add chain as the
standalone per-request metric, on the CPU and on the card alike (a
segment holds one row, so the atomic adds have no order to differ in);
the ngram mirror uses the standalone metric's integer hash fold. So
step-by-step per-key ``compute()`` matches the standalone metrics
bitwise, including after a sync and a mid-stream elastic resume.
"""

from __future__ import annotations

import time
from functools import lru_cache
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from torcheval_tpu_torch.metrics.shardspec import ShardContext
from torcheval_tpu_torch.streaming._mix import mix_fold_int
from torcheval_tpu_torch.streaming.ngram import _sum_orders
from torcheval_tpu_torch.table._admission import AdmissionController
from torcheval_tpu_torch.table._families import FAMILIES, TableFamily, _rows_1d, _weight_rows
from torcheval_tpu_torch.table._hash import hash_keys
from torcheval_tpu_torch.table.panel import TablePanel
from torcheval_tpu_torch.table.table import _as_numpy

__all__ = [
    "StreamTable",
    "stream_logprob_family",
    "stream_token_edit_family",
    "stream_token_accuracy_family",
    "stream_ngram_family",
]


# ----------------------------------------------------------- logprob family


def _logprob_rows(logprobs, live):
    v = torch.broadcast_to(live.to(torch.float32), logprobs.shape)
    return -logprobs.to(torch.float32) * v, v


def _logprob_prepare(view, logprobs, live=1.0):
    lp = _rows_1d(view, "logprobs", logprobs, dtype=torch.float32)
    return (lp, _weight_rows(view, live, lp)), ()


def _logprob_compute(cols):
    tok = cols["tokens"]
    safe = torch.where(tok > 0, tok, 1.0)
    # the per-key twin of _perplexity_compute: exp(mean NLL); a key with
    # no tokens yet reads 0.0
    return torch.where(tok > 0, torch.exp(cols["nll"] / safe), 0.0)


def stream_logprob_family() -> TableFamily:
    """Per-request running perplexity (fields ``nll``/``tokens``)."""
    return FAMILIES["stream_logprob"]


# -------------------------------------------------------- token-edit family


def _token_edit_rows(hyp, ref):
    hyp_valid = hyp >= 0
    ref_valid = ref >= 0
    both = hyp_valid & ref_valid

    def f(m):
        return m.to(torch.float32)

    return (
        f(both & (hyp == ref)),
        f(both & (hyp != ref)),
        f(hyp_valid & ~ref_valid),
        f(ref_valid & ~hyp_valid),
        f(hyp_valid),
        f(ref_valid),
    )


def _token_edit_prepare(view, step_tokens, ref_tokens=None):
    hyp = _rows_1d(view, "step_tokens", step_tokens, dtype=torch.int32)
    if ref_tokens is None:
        ref = torch.full(hyp.shape, -1, dtype=torch.int32, device=hyp.device)
    else:
        ref = _rows_1d(view, "ref_tokens", ref_tokens, dtype=torch.int32)
    if hyp.shape != ref.shape:
        raise ValueError(
            "stream token rows: step_tokens and ref_tokens must align "
            f"(got {tuple(hyp.shape)} vs {tuple(ref.shape)})"
        )
    return (hyp, ref), ()


_EDIT_FIELDS = (
    "matches",
    "substitutions",
    "insertions",
    "deletions",
    "hyp_tokens",
    "ref_tokens",
)


def _token_edit_compute(cols):
    ref = cols["ref_tokens"]
    errors = cols["substitutions"] + cols["insertions"] + cols["deletions"]
    return torch.where(ref > 0, errors / torch.clamp(ref, min=1.0), 0.0)


def _token_accuracy_compute(cols):
    ref = cols["ref_tokens"]
    return torch.where(ref > 0, cols["matches"] / torch.clamp(ref, min=1.0), 0.0)


def stream_token_edit_family() -> TableFamily:
    """Per-request WER-style error rate (S+I+D over reference tokens)."""
    return FAMILIES["stream_token_edit"]


def stream_token_accuracy_family() -> TableFamily:
    """Per-request token accuracy (same row kernel as ``token_edit``)."""
    return FAMILIES["stream_token_accuracy"]


FAMILIES["stream_logprob"] = TableFamily(
    name="stream_logprob",
    fields=("nll", "tokens"),
    prepare=_logprob_prepare,
    row_kernel=_logprob_rows,
    compute=_logprob_compute,
)
FAMILIES["stream_token_edit"] = TableFamily(
    name="stream_token_edit",
    fields=_EDIT_FIELDS,
    prepare=_token_edit_prepare,
    row_kernel=_token_edit_rows,
    compute=_token_edit_compute,
)
FAMILIES["stream_token_accuracy"] = TableFamily(
    name="stream_token_accuracy",
    fields=_EDIT_FIELDS,
    prepare=_token_edit_prepare,
    row_kernel=_token_edit_rows,  # SAME kernel object: one shared program
    compute=_token_accuracy_compute,
)


# ------------------------------------------------------------- ngram family


@lru_cache(maxsize=None)
def _payload_rows_kernel(n_fields: int):
    """Raw column unstack: the ngram member's device work is a plain
    scatter of host-prepared payload columns (cached per arity so every
    same-shape ngram member shares one kernel object)."""

    def rows(payload):
        return tuple(payload[:, j] for j in range(n_fields))

    return rows


def _ngram_fields(n_gram: int) -> Tuple[str, ...]:
    return (
        ("hyp_tokens", "ref_tokens")
        + tuple(f"matches_{k}" for k in range(1, n_gram + 1))
        + tuple(f"possible_{k}" for k in range(1, n_gram + 1))
        + ("finished",)
    )


def _ngram_prepare(view, payload):
    arr = view._input(payload, dtype=torch.float32)
    if arr.ndim != 2:
        raise ValueError(
            "stream ngram member expects the host-prepared payload "
            f"matrix, got shape {tuple(arr.shape)}"
        )
    return (arr,), ()


@lru_cache(maxsize=None)
def _ngram_member_compute(n_gram: int):
    def compute(cols):
        # the vectorized per-key twin of streaming.ngram._ngram_compute:
        # identical elementwise expressions and the same left fold over
        # the orders, so a finished request's keyed overlap equals the
        # standalone metric's bitwise
        m = torch.stack([cols[f"matches_{k}"] for k in range(1, n_gram + 1)], dim=0)
        p = torch.stack([cols[f"possible_{k}"] for k in range(1, n_gram + 1)], dim=0)
        used = p > 0
        safe_p = torch.where(used, p, 1.0)
        log_prec = torch.where(
            used & (m > 0), torch.log(torch.where(m > 0, m, 1.0) / safe_p), 0.0
        )
        n_used = torch.sum(used.to(torch.float32), dim=0)
        geo = torch.exp(_sum_orders(log_prec) / torch.clamp(n_used, min=1.0))
        geo = torch.where(torch.any(used & (m == 0), dim=0) | (n_used == 0), 0.0, geo)
        h = cols["hyp_tokens"]
        r = cols["ref_tokens"]
        bp = torch.where(h >= r, 1.0, torch.exp(1.0 - r / torch.where(h > 0, h, 1.0)))
        bp = torch.where(h > 0, bp, 0.0)
        return torch.where(cols["finished"] > 0, geo * bp, 0.0)

    return compute


@lru_cache(maxsize=None)
def stream_ngram_family(n_gram: int = 4) -> TableFamily:
    """Per-request clipped n-gram overlap (host-mirrored tails/planes,
    finals committed at ``finish``). Cached per order so repeated tables
    share the kernel object (CUDA-graph identity)."""
    fields = _ngram_fields(n_gram)
    return TableFamily(
        name=f"stream_ngram{n_gram}",
        fields=fields,
        prepare=_ngram_prepare,
        row_kernel=_payload_rows_kernel(len(fields)),
        compute=_ngram_member_compute(n_gram),
    )


# ------------------------------------------------------- per-request mirror


class _StreamState:
    """Host-side O(1) state of one in-flight request on its observing
    rank: span bookkeeping (steps, wall start) always; ngram tails and
    hashed count planes only when the ``ngram`` member is on."""

    __slots__ = (
        "t0",
        "steps",
        "hyp_len",
        "ref_len",
        "hyp_tail",
        "ref_tail",
        "cand",
        "refc",
    )

    def __init__(self, n_gram: Optional[int], buckets: int):
        self.t0 = time.monotonic()
        self.steps = 0
        self.hyp_len = 0
        self.ref_len = 0
        self.hyp_tail: List[int] = []
        self.ref_tail: List[int] = []
        if n_gram is None:
            self.cand = None
            self.refc = None
        else:
            self.cand = np.zeros((n_gram, buckets), np.int64)
            self.refc = np.zeros((n_gram, buckets), np.int64)

    def __deepcopy__(self, memo) -> "_StreamState":
        # a sync or snapshot clones the whole mirror (thousands of
        # requests): copy the slots directly, not through the generic
        # reduce protocol
        new = object.__new__(_StreamState)
        new.t0, new.steps = self.t0, self.steps
        new.hyp_len, new.ref_len = self.hyp_len, self.ref_len
        new.hyp_tail, new.ref_tail = list(self.hyp_tail), list(self.ref_tail)
        new.cand = None if self.cand is None else self.cand.copy()
        new.refc = None if self.refc is None else self.refc.copy()
        return new


def _mirror_push(counts, tail, length, tok, n_gram, buckets):
    """The host twin of streaming.ngram's device fold: same window, same
    hash (``mix_fold_int``), same >=k gating — integer-exact parity."""
    length += 1
    window = tail + [tok]
    for k in range(1, min(n_gram, length) + 1):
        h = mix_fold_int(window[-k:])
        counts[k - 1, h & (buckets - 1)] += 1
    tail.append(tok)
    if n_gram > 1:
        del tail[: max(len(tail) - (n_gram - 1), 0)]
    else:
        tail.clear()
    return length


# ----------------------------------------------------------------- the table


_MEMBER_NAMES = ("logprob", "token_edit", "token_accuracy", "ngram")


class StreamTable(TablePanel):
    """Streaming generative quality keyed by request id (module docstring).

    Args:
        members: which streaming families to carry — a subset of
            ``("logprob", "token_edit", "token_accuracy", "ngram")``.
        n_gram / ngram_buckets: the ``ngram`` member's order and hashed
            count-plane width (as ``streaming.StreamingNgramOverlap``).
        hist_bins: bin count of the finished-request distribution
            sketches (length, latency, per-member final values).
        shard / ttl / max_keys / repr_limit / admission /
            staleness_epochs / device: as :class:`MetricTable`.

    Examples::

        >>> import numpy as np
        >>> from torcheval_tpu_torch.table import StreamTable
        >>> t = StreamTable(members=("logprob",), device="cpu")
        >>> _ = t.ingest([7, 9], logprobs=np.array([-0.1, -2.0]))
        >>> _ = t.ingest([7], logprobs=np.array([-0.3]))
        >>> round(t.compute().as_dict()["logprob"][7], 4)  # running ppl
        1.2214
    """

    def __init__(
        self,
        members: Sequence[str] = ("logprob", "token_edit"),
        *,
        n_gram: int = 4,
        ngram_buckets: int = 128,
        hist_bins: int = 24,
        shard: Optional[ShardContext] = None,
        ttl: Optional[int] = None,
        max_keys: Optional[int] = None,
        repr_limit: int = 4096,
        admission: Optional[AdmissionController] = None,
        staleness_epochs: Optional[int] = None,
        device: Optional[Any] = None,
    ) -> None:
        members = tuple(members)
        if not members:
            raise ValueError("StreamTable needs at least one member")
        unknown = sorted(set(members) - set(_MEMBER_NAMES))
        if unknown:
            raise ValueError(
                f"unknown StreamTable members {unknown}; available: "
                f"{list(_MEMBER_NAMES)}"
            )
        if len(set(members)) != len(members):
            raise ValueError(f"duplicate StreamTable members in {members}")
        panel_members: List[Tuple[str, TableFamily]] = []
        for name in members:
            if name == "logprob":
                panel_members.append((name, stream_logprob_family()))
            elif name == "token_edit":
                panel_members.append((name, stream_token_edit_family()))
            elif name == "token_accuracy":
                panel_members.append((name, stream_token_accuracy_family()))
            else:
                panel_members.append((name, stream_ngram_family(int(n_gram))))
        super().__init__(
            panel_members,
            shard=shard,
            ttl=ttl,
            max_keys=max_keys,
            repr_limit=repr_limit,
            admission=admission,
            staleness_epochs=staleness_epochs,
            device=device,
        )
        self.n_gram = int(n_gram)
        if ngram_buckets < 1 or (ngram_buckets & (ngram_buckets - 1)) != 0:
            raise ValueError(
                f"ngram_buckets must be a power of two, got {ngram_buckets}"
            )
        self.ngram_buckets = int(ngram_buckets)
        self._stream_members = members
        self._has_ngram = "ngram" in members
        # per-request host mirror (observing rank), finished-but-undrained
        # hash set, and the finished-request distribution sketches:
        # `base` only changes at drains on merged state (identical on
        # every rank afterwards — MAX-merged), `pending` holds this
        # rank's since-last-drain length/latency observations (SUM-merged,
        # folded into base at the merge/drain point)
        self._streams: Dict[int, _StreamState] = {}
        self._finished: set = set()
        self._finished_total = 0
        bins = int(hist_bins)
        if bins < 2:
            raise ValueError(f"hist_bins must be >= 2, got {hist_bins}")
        edges: Dict[str, np.ndarray] = {
            "length": np.concatenate(
                [[0.0], np.logspace(0.0, 6.0, bins, base=10.0)]
            ),
            "latency": np.logspace(-4.0, 3.0, bins + 1),
        }
        for name in members:
            if name == "logprob":
                edges["final_logprob"] = np.logspace(0.0, 5.0, bins + 1)
            elif name == "token_edit":
                edges["final_token_edit"] = np.linspace(0.0, 2.0, bins + 1)
            elif name == "token_accuracy":
                edges["final_token_accuracy"] = np.linspace(0.0, 1.0, bins + 1)
            else:
                edges["final_ngram"] = np.linspace(0.0, 1.0, bins + 1)
        self._hist_edges = edges
        self._fin_base = {
            k: np.zeros(len(v) - 1, np.int64) for k, v in edges.items()
        }
        self._fin_pending = {
            k: np.zeros(len(v) - 1, np.int64) for k, v in edges.items()
        }

    # ------------------------------------------------------------- intake

    @property
    def active_requests(self) -> int:
        """In-flight requests this rank is observing (host mirror size)."""
        return len(self._streams)

    def ingest(
        self,
        request_ids: Any,
        *,
        step_tokens: Any = None,
        logprobs: Any = None,
        ref_tokens: Any = None,
    ) -> "StreamTable":
        """Fold one decode step for a batch of active requests: one
        ingest (bucketed; empty batches are free).

        Args:
            request_ids: one id per decode row (any hashable key kind).
            step_tokens: sampled token ids aligned with the ids (``-1``
                = no token); required by token/ngram members.
            logprobs: per-token log-probabilities aligned with the ids;
                required by the ``logprob`` member.
            ref_tokens: reference tokens aligned with the ids (``-1`` /
                ``None`` = reference exhausted or absent).
        """
        ids = _as_numpy(request_ids).reshape(-1)
        hashed = hash_keys(ids)
        self._observe_step(hashed, step_tokens, logprobs, ref_tokens)
        bundles = self._step_bundles(
            int(hashed.size), step_tokens, logprobs, ref_tokens
        )
        from torcheval_tpu_torch.obs import trace as obs_trace
        from torcheval_tpu_torch.obs.recorder import RECORDER

        with obs_trace.scope_or_null("stream_table.ingest", RECORDER.enabled):
            super().ingest(ids, **bundles)
        return self

    def _step_bundles(
        self, n: int, step_tokens, logprobs, ref_tokens
    ) -> Dict[str, Any]:
        bundles: Dict[str, Any] = {}
        for name in self._stream_members:
            if name == "logprob":
                if logprobs is None:
                    raise ValueError(
                        "StreamTable has a 'logprob' member: pass "
                        "logprobs= to ingest()"
                    )
                bundles[name] = (logprobs,)
            elif name in ("token_edit", "token_accuracy"):
                if step_tokens is None:
                    raise ValueError(
                        f"StreamTable has a {name!r} member: pass "
                        "step_tokens= to ingest()"
                    )
                bundles[name] = (step_tokens, ref_tokens)
            else:
                # the ngram member's stream state lives in the host
                # mirror; decode-step rows contribute zero columns (the
                # row still admits the key and touches last_seen)
                width = len(_ngram_fields(self.n_gram))
                bundles[name] = (torch.zeros((n, width), dtype=torch.float32, device=self.device),)
        return bundles

    def _observe_step(self, hashed, step_tokens, logprobs, ref_tokens) -> None:
        n = int(hashed.size)
        if n == 0:
            return
        hyp = ref = None
        if step_tokens is not None:
            hyp = _as_numpy(step_tokens).astype(np.int64).reshape(-1)
        if ref_tokens is not None:
            ref = _as_numpy(ref_tokens).astype(np.int64).reshape(-1)
        ng = self.n_gram if self._has_ngram else None
        for i, h in enumerate(hashed.tolist()):
            st = self._streams.get(h)
            if st is None:
                st = _StreamState(ng, self.ngram_buckets)
                self._streams[h] = st
            st.steps += 1
            if hyp is not None and hyp[i] >= 0:
                if st.cand is not None:
                    st.hyp_len = _mirror_push(
                        st.cand,
                        st.hyp_tail,
                        st.hyp_len,
                        int(hyp[i]),
                        self.n_gram,
                        self.ngram_buckets,
                    )
                else:
                    st.hyp_len += 1
            elif hyp is None and logprobs is not None:
                st.hyp_len += 1
            if ref is not None and ref[i] >= 0:
                if st.refc is not None:
                    st.ref_len = _mirror_push(
                        st.refc,
                        st.ref_tail,
                        st.ref_len,
                        int(ref[i]),
                        self.n_gram,
                        self.ngram_buckets,
                    )
                else:
                    st.ref_len += 1

    # -------------------------------------------------------------- finish

    def finish(self, request_ids: Any) -> "StreamTable":
        """Retire completed requests: stamp their per-request spans
        (length/latency sketches + an obs ``SpanEvent`` per request when
        the recorder is on), commit the ngram finals in one fused row
        batch, and mark the slots for eviction at the next drain."""
        ids = _as_numpy(request_ids).reshape(-1)
        hashed = hash_keys(ids)
        if hashed.size == 0:
            return self
        now = time.monotonic()
        lengths: List[float] = []
        latencies: List[float] = []
        finals_ids: List[Any] = []
        finals_rows: List[np.ndarray] = []
        from torcheval_tpu_torch.obs.recorder import RECORDER

        for rid, h in zip(ids.tolist(), hashed.tolist()):
            if h in self._finished:
                continue
            self._finished.add(h)
            st = self._streams.pop(h, None)
            if st is None:
                continue
            lengths.append(float(st.steps))
            latencies.append(max(now - st.t0, 0.0))
            if RECORDER.enabled:
                from torcheval_tpu_torch.obs.events import SpanEvent

                RECORDER.record(
                    SpanEvent(
                        name="stream_request", seconds=max(now - st.t0, 0.0)
                    )
                )
            if self._has_ngram and st.cand is not None:
                clipped = np.minimum(st.cand, st.refc).sum(axis=1)
                orders = np.arange(1, self.n_gram + 1)
                possible = np.maximum(st.hyp_len - orders + 1, 0)
                row = np.concatenate(
                    [
                        [float(st.hyp_len), float(st.ref_len)],
                        clipped.astype(np.float64),
                        possible.astype(np.float64),
                        [1.0],
                    ]
                )
                finals_ids.append(rid)
                finals_rows.append(row.astype(np.float32))
        if lengths:
            for name, vals in (("length", lengths), ("latency", latencies)):
                self._fin_pending[name] += np.histogram(
                    np.asarray(vals), bins=self._hist_edges[name]
                )[0].astype(np.int64)
        if finals_rows:
            self._commit_finals(finals_ids, np.stack(finals_rows))
        return self

    def _commit_finals(self, ids: List[Any], payload: np.ndarray) -> None:
        n = len(ids)
        bundles: Dict[str, Any] = {}
        for name in self._stream_members:
            if name == "logprob":
                # zero rows with live=0.0: no token counted, no NLL moved
                bundles[name] = (np.zeros((n,), np.float32), 0.0)
            elif name in ("token_edit", "token_accuracy"):
                sent = np.full((n,), -1, np.int32)
                bundles[name] = (sent, sent)
            else:
                bundles[name] = (payload,)
        # finals must not be shed: admission gates DECODE rows (load), not
        # the retirement commit (bounded: one row per request lifetime)
        ctrl = self._admission
        self._admission = None
        try:
            TablePanel.ingest(self, np.asarray(ids).reshape(-1), **bundles)
        finally:
            self._admission = ctrl

    def finished_summary(self) -> Dict[str, Dict[str, np.ndarray]]:
        """The finished-request distribution sketches: ``{name:
        {"edges": bin edges, "counts": committed + pending}}`` for
        request length, wall latency, and each member's final value."""
        return {
            name: {
                "edges": self._hist_edges[name].copy(),
                "counts": (
                    self._fin_base[name] + self._fin_pending[name]
                ).copy(),
            }
            for name in self._hist_edges
        }

    # ------------------------------------------------------- merge / drain

    def merge_state(self, metrics: Any) -> "StreamTable":
        others = list(metrics)
        carriers = [self] + others
        finished: set = set()
        streams: Dict[int, _StreamState] = {}
        for c in carriers:
            finished |= c._finished
            for h, st in c._streams.items():
                cur = streams.get(h)
                # one rank observes a given request's traffic, so at most
                # one copy advanced past the last adopt — keep it
                if cur is None or st.steps > cur.steps:
                    streams[h] = st
        base = {
            k: np.maximum.reduce([c._fin_base[k] for c in carriers])
            for k in self._fin_base
        }
        # fold every rank's pending observations at the merge point (the
        # logical-assembly step), so the merged payload is replay-equal
        # to a world-1 run and re-loading it cannot double-count
        for k in base:
            for c in carriers:
                base[k] = base[k] + c._fin_pending[k]
        finished_total = max(int(c._finished_total) for c in carriers)
        super().merge_state(others)
        self._finished = finished
        self._streams = streams
        self._fin_base = base
        self._fin_pending = {
            k: np.zeros_like(v) for k, v in self._fin_pending.items()
        }
        self._finished_total = finished_total
        return self

    def _pre_adopt_commit(self) -> None:
        # world-1 drains never ran merge_state: fold local pending here
        # (idempotent after a merge — pending is already zero)
        for k in self._fin_base:
            self._fin_base[k] = self._fin_base[k] + self._fin_pending[k]
            self._fin_pending[k] = np.zeros_like(self._fin_pending[k])
        fin = np.asarray(sorted(self._finished), np.uint64)
        n = int(self.n_keys)
        if fin.size and n:
            pos = np.searchsorted(self._keys, fin)
            pos_c = np.minimum(pos, n - 1)
            present = (pos < n) & (self._keys[pos_c] == fin)
            rows = pos_c[present]
            if rows.size:
                # per-request finals -> cumulative distribution sketches,
                # from MERGED per-key values (deterministic on every
                # rank; host readback at drain cadence only)
                pv = self.compute()
                for alias in self._stream_members:
                    vals = _as_numpy(pv.values[alias])[rows]
                    key = f"final_{alias}"
                    self._fin_base[key] += np.histogram(
                        vals, bins=self._hist_edges[key]
                    )[0].astype(np.int64)
                keep = np.ones((n,), bool)
                keep[rows] = False
                self._keep_subset(np.flatnonzero(keep))
                self._finished_total += int(rows.size)
        self._finished = set()
        super()._pre_adopt_commit()
        # prune mirror entries whose slots no longer exist (finished
        # above, or TTL/occupancy-evicted mid-stream)
        if self._streams:
            live = set(int(k) for k in self._keys)
            self._streams = {
                h: st for h, st in self._streams.items() if h in live
            }

    # ------------------------------------------------------- serialization

    def state_dict(self) -> Dict[str, Any]:
        sd = super().state_dict()
        now = time.monotonic()
        streams = tuple(
            (
                int(h),
                int(st.steps),
                float(max(now - st.t0, 0.0)),  # elapsed, rebased on load
                int(st.hyp_len),
                int(st.ref_len),
                tuple(st.hyp_tail),
                tuple(st.ref_tail),
                None if st.cand is None else st.cand.copy(),
                None if st.refc is None else st.refc.copy(),
            )
            for h, st in sorted(self._streams.items())
        )
        # a TUPLE, not a dict: the sync packer ships non-array/list/dict
        # states verbatim as picklable objects (the key_reprs discipline),
        # while a dict's values would each have to be np.asarray-able
        sd["stream_extras"] = (
            tuple(sorted(self._finished)),
            streams,
            tuple((k, v.copy()) for k, v in sorted(self._fin_base.items())),
            tuple(
                (k, v.copy()) for k, v in sorted(self._fin_pending.items())
            ),
            int(self._finished_total),
        )
        return sd

    def load_state_dict(
        self, state_dict: Dict[str, Any], strict: bool = True
    ) -> None:
        sd = dict(state_dict)
        extras = sd.pop("stream_extras", None)
        logical = int(np.asarray(sd.get("_owner_rank", -1))) < 0
        super().load_state_dict(sd, strict)
        if extras is None:
            self._streams = {}
            self._finished = set()
            return
        fin_hashes, stream_rows, base_items, pending_items, total = extras
        now = time.monotonic()
        streams: Dict[int, _StreamState] = {}
        ng = self.n_gram if self._has_ngram else None
        for h, steps, elapsed, hlen, rlen, htail, rtail, cand, refc in (
            stream_rows
        ):
            st = _StreamState(None, self.ngram_buckets)
            st.t0 = now - float(elapsed)
            st.steps = int(steps)
            st.hyp_len = int(hlen)
            st.ref_len = int(rlen)
            st.hyp_tail = [int(t) for t in htail]
            st.ref_tail = [int(t) for t in rtail]
            if cand is not None:
                st.cand = np.array(cand, np.int64)
                st.refc = np.array(refc, np.int64)
            elif ng is not None:
                st.cand = np.zeros((ng, self.ngram_buckets), np.int64)
                st.refc = np.zeros((ng, self.ngram_buckets), np.int64)
            streams[int(h)] = st
        self._streams = streams
        self._finished = set(int(x) for x in fin_hashes)
        self._fin_base = {k: np.array(v, np.int64) for k, v in base_items}
        pending = {k: np.array(v, np.int64) for k, v in pending_items}
        if logical and self.rank != 0:
            # a logical payload replicated across ranks must not multiply
            # un-drained pending observations (rank 0 keeps the one copy)
            pending = {k: np.zeros_like(v) for k, v in pending.items()}
        self._fin_pending = pending
        self._finished_total = int(total)

    def reset(self) -> "StreamTable":
        super().reset()
        self._streams = {}
        self._finished = set()
        self._finished_total = 0
        self._fin_base = {k: np.zeros_like(v) for k, v in self._fin_base.items()}
        self._fin_pending = {
            k: np.zeros_like(v) for k, v in self._fin_pending.items()
        }
        return self

    # ---------------------------------------------------------------- obs

    def counter_source(self) -> Dict[str, Any]:
        out = super().counter_source()
        out["active_requests"] = len(self._streams)
        out["finished_pending"] = len(self._finished)
        out["finished_requests_total"] = int(self._finished_total)
        return out
