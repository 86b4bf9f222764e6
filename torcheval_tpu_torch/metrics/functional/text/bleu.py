"""BLEU score (counterpart of
``torcheval_tpu/metrics/functional/text/bleu.py``).

The counting is host numpy, as in the JAX package: a batch is flattened
into one token stream, integer-coded by one ``np.unique``, and each
order's clipped n-gram matches come from sliding-window row dedup and
grouped bincounts. The per-update result is a small vector of counters;
the score is computed from them in float32 torch ops on the device.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from torcheval_tpu_torch.utils.convert import (
    DeviceLike,
    functional_device,
    narrow_64,
    to_torch,
)


def _encode_corpus(
    candidates: Sequence[Sequence[str]],
    references: Sequence[Sequence[Sequence[str]]],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
    """Flatten a tokenized batch into one integer-coded token stream.

    Returns ``(ids, sent_serial, pair_idx, ref_local, max_refs)``, each
    array with one entry a token: ``ids`` the token's integer code (dense,
    from one global ``np.unique``), ``sent_serial`` a distinct serial a
    sentence (so n-gram windows never straddle sentences), ``pair_idx``
    the candidate/reference pair, and ``ref_local`` the reference's index
    within its pair (-1 for candidate tokens).
    """
    flat: List[str] = []
    serial: List[int] = []
    pair: List[int] = []
    ref_local: List[int] = []
    sent = 0
    max_refs = 0
    for i, (cand, refs) in enumerate(zip(candidates, references)):
        flat.extend(cand)
        serial.extend([sent] * len(cand))
        pair.extend([i] * len(cand))
        ref_local.extend([-1] * len(cand))
        sent += 1
        max_refs = max(max_refs, len(refs))
        for r, ref in enumerate(refs):
            flat.extend(ref)
            serial.extend([sent] * len(ref))
            pair.extend([i] * len(ref))
            ref_local.extend([r] * len(ref))
            sent += 1
    if not flat:
        ids = np.zeros(0, dtype=np.int64)
    else:
        _, ids = np.unique(np.asarray(flat), return_inverse=True)
        ids = ids.astype(np.int64, copy=False)
    return (
        ids,
        np.asarray(serial, dtype=np.int64),
        np.asarray(pair, dtype=np.int64),
        np.asarray(ref_local, dtype=np.int64),
        max_refs,
    )


def _clipped_matches_per_order(
    ids: np.ndarray,
    sent_serial: np.ndarray,
    pair_idx: np.ndarray,
    ref_local: np.ndarray,
    max_refs: int,
    n_gram: int,
) -> np.ndarray:
    """Clipped n-gram match totals for orders ``1..n_gram``.

    For order ``n``, every length-``n`` window inside one sentence becomes
    a row ``[pair, tok_0..tok_{n-1}]``; ``np.unique`` over rows gives each
    distinct (pair, n-gram) a group id, and the clipped match count is
    ``sum_g min(cand_count[g], max_ref ref_count[g, ref])``.
    """
    matches = np.zeros(n_gram, dtype=np.float64)
    total = ids.shape[0]
    for n in range(1, n_gram + 1):
        n_windows = total - n + 1
        if n_windows <= 0:
            continue
        starts = np.arange(n_windows)
        inside = sent_serial[starts] == sent_serial[starts + n - 1]
        starts = starts[inside]
        if starts.size == 0:
            continue
        rows = np.empty((starts.size, n + 1), dtype=np.int64)
        rows[:, 0] = pair_idx[starts]
        for k in range(n):
            rows[:, k + 1] = ids[starts + k]
        _, group = np.unique(rows, axis=0, return_inverse=True)
        group = group.reshape(-1)
        n_groups = int(group.max()) + 1

        from_cand = ref_local[starts] < 0
        cand_counts = np.bincount(group[from_cand], minlength=n_groups)

        ref_groups = group[~from_cand]
        ref_ids = ref_local[starts][~from_cand]
        # per-(group, reference) counts, only the populated pairs, then the
        # per-group max across references: the multi-reference clip
        pair_keys, pair_counts = np.unique(
            ref_groups * max_refs + ref_ids, return_counts=True
        )
        ref_ceiling = np.zeros(n_groups, dtype=np.int64)
        np.maximum.at(ref_ceiling, pair_keys // max_refs, pair_counts)

        matches[n - 1] = np.minimum(cand_counts, ref_ceiling).sum()
    return matches


def _bleu_score_update(
    input: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    n_gram: int,
) -> Tuple[float, float, np.ndarray, np.ndarray]:
    """Candidate and (shortest) reference lengths, clipped matches and
    possible matches per order for one batch, as host values."""
    input_ = [input] if isinstance(input, str) else input
    target_ = [[tgt] if isinstance(tgt, str) else tgt for tgt in target]

    if len(input_) != len(target_):
        raise ValueError(
            "Input and target corpus should have same sizes, but input "
            f"corpus size = {len(input_)}, target corpus size = {len(target_)} "
        )

    cand_tok = [c.split() for c in input_]
    ref_tok = [[r.split() for r in refs] for refs in target_]

    cand_lens = np.asarray([len(t) for t in cand_tok], dtype=np.int64)
    ref_min_lens = np.asarray(
        [min(len(r) for r in refs) for refs in ref_tok], dtype=np.int64
    )
    input_len = float(cand_lens.sum())
    target_len = float(ref_min_lens.sum())

    orders = np.arange(n_gram, dtype=np.int64)
    possible_matches_by_order = (
        np.maximum(cand_lens[:, None] - orders[None, :], 0)
        .sum(axis=0)
        .astype(np.float64)
    )
    if possible_matches_by_order.size == 0 or possible_matches_by_order.min() == 0:
        raise ValueError(
            "the input is too short to find all n-gram matches with "
            f"n_gram={n_gram}"
        )

    matches_by_order = _clipped_matches_per_order(
        *_encode_corpus(cand_tok, ref_tok), n_gram
    )
    return input_len, target_len, matches_by_order, possible_matches_by_order


def _bleu_weights(weights, n_gram: int, device: torch.device) -> torch.Tensor:
    """Per-order weights on ``device`` (uniform float32 when ``None``)."""
    if weights is None:
        return torch.full((n_gram,), 1 / n_gram, dtype=torch.float32, device=device)
    weights = narrow_64(to_torch(weights, device=device))
    if n_gram != weights.shape[0]:
        raise ValueError(
            "the length of weights should equal n_gram, got "
            f"len(weights)={weights.shape[0]}, n_gram={n_gram}"
        )
    return weights


def _bleu_score_compute(
    input_len,
    target_len,
    matches_by_order,
    possible_matches_by_order,
    n_gram: int,
    weights=None,
    *,
    device: torch.device,
) -> torch.Tensor:
    """The score from the counters, in float32 on ``device``."""
    weights = _bleu_weights(weights, n_gram, device)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    input_len, target_len = f32(input_len), f32(target_len)
    precisions = f32(matches_by_order) / f32(possible_matches_by_order)
    geometric_mean = torch.exp(torch.sum(weights * torch.log(precisions)))
    # the penalty is 1 only when the candidates are strictly longer
    brevity_penalty = torch.where(
        input_len > target_len, 1.0, torch.exp(1 - target_len / input_len)
    )
    return brevity_penalty * geometric_mean


def bleu_score(
    input: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    n_gram: int = 4,
    weights=None,
    *,
    device: DeviceLike = None,
) -> torch.Tensor:
    """BLEU score of translations against (multi-)references (class
    version: ``BLEUScore``).

    Args:
        input: translations to score, a string or a sequence of strings.
        target: the references of each translation;
            ``len(input) == len(target)``.
        n_gram: maximum n-gram order, in {1, 2, 3, 4}.
        weights: per-order weights of length ``n_gram`` (uniform if
            ``None``).
        device: where the score is computed (the weights' device, else
            CUDA).

    >>> from torcheval_tpu_torch.metrics.functional import bleu_score
    >>> candidates = ["the squirrel is eating the nut"]
    >>> references = [["a squirrel is eating a nut",
    ...                "the squirrel is eating a tasty nut"]]
    >>> bleu_score(candidates, references, n_gram=4, device="cpu")
    tensor(0.5373)
    """
    if n_gram not in (1, 2, 3, 4):
        raise ValueError(f"n_gram should be 1, 2, 3, or 4, got {n_gram}.")
    dev = functional_device(device, weights)
    counters = _bleu_score_update(input, target, n_gram)
    return _bleu_score_compute(*counters, n_gram, weights, device=dev)
