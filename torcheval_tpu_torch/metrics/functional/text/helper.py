"""Host-side helpers of the text family (a copy of
``torcheval_tpu/metrics/functional/text/helper.py``, which is numpy only;
the port keeps its own copy so that it imports nothing of the JAX
package).

Word-level edit distance runs as a numpy row DP: each row is one
``minimum.accumulate`` scan, so the Python-level loop is O(n), not O(n*m).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

import numpy as np


def _tokens_to_ids(tokens: Sequence[str], vocab: Dict[str, int]) -> np.ndarray:
    return np.fromiter(
        (vocab.setdefault(tok, len(vocab)) for tok in tokens),
        dtype=np.int64,
        count=len(tokens),
    )


def _edit_distance(
    prediction_tokens: List[str],
    reference_tokens: List[str],
) -> int:
    """Word-level Levenshtein distance between two token sequences.

    Row ``i`` of the DP is ``cur[j] = j + min(i, min_{k<=j}(cand[k] - k))``
    with ``cand[k] = min(prev[k]+1, prev[k-1]+cost[k])``: the within-row
    dependency ``cur[j-1]+1`` is a running minimum of ``cand[k]-k``.
    """
    n, m = len(prediction_tokens), len(reference_tokens)
    if n == 0 or m == 0:
        return max(n, m)
    vocab: Dict[str, int] = {}
    pred_ids = _tokens_to_ids(prediction_tokens, vocab)
    ref_ids = _tokens_to_ids(reference_tokens, vocab)

    offsets = np.arange(m + 1, dtype=np.int64)
    prev = offsets.copy()
    for i in range(1, n + 1):
        cost = (ref_ids != pred_ids[i - 1]).astype(np.int64)
        cand = np.minimum(prev[1:] + 1, prev[:-1] + cost)
        shifted = np.concatenate(([i], cand - offsets[1:]))
        prev = np.minimum.accumulate(shifted) + offsets
    return int(prev[-1])


def _get_errors_and_totals(
    input: Union[str, List[str]],
    target: Union[str, List[str]],
) -> Tuple[float, float, float, float]:
    """Summed edit distance, summed max lengths, and the lengths of the
    target and input corpora, as host floats."""
    if isinstance(input, str):
        input = [input]
    if isinstance(target, str):
        target = [target]
    errors = 0.0
    max_total = 0.0
    target_total = 0.0
    input_total = 0.0
    for ipt, tgt in zip(input, target):
        input_tokens = ipt.split()
        target_tokens = tgt.split()
        errors += _edit_distance(input_tokens, target_tokens)
        target_total += len(target_tokens)
        input_total += len(input_tokens)
        max_total += max(len(target_tokens), len(input_tokens))
    return errors, max_total, target_total, input_total


def _text_input_check(input, target) -> None:
    """Type and length checks shared by WER, WIL and WIP."""
    if type(input) != type(target):  # noqa: E721 -- the JAX package's rule
        raise ValueError(
            f"input and target should have the same type, got {type(input)} "
            f"and {type(target)}."
        )
    if isinstance(input, list) and len(input) != len(target):
        raise ValueError(
            "input and target lists should have the same length, got "
            f"{len(input)} and {len(target)}",
        )
