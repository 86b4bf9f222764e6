"""Word error rate (counterpart of
``torcheval_tpu/metrics/functional/text/word_error_rate.py``): host-side
string processing with the numpy edit distance of ``helper.py``; the
counters are host floats."""

from __future__ import annotations

from typing import List, Tuple, Union

import torch

from torcheval_tpu_torch.metrics.functional.text.helper import (
    _edit_distance,
    _text_input_check,
)
from torcheval_tpu_torch.utils.convert import DeviceLike, functional_device


def _f32(x: float, device: torch.device) -> torch.Tensor:
    """A host count as a float32 scalar on ``device``: the JAX package
    casts both counts to float32, then divides."""
    return torch.tensor(x, dtype=torch.float32, device=device)


def _word_error_rate_update(
    input: Union[str, List[str]],
    target: Union[str, List[str]],
) -> Tuple[float, float]:
    """Summed edit distance and reference-token count of the batch."""
    _text_input_check(input, target)
    if isinstance(input, str):
        input = [input]
    if isinstance(target, str):
        target = [target]
    errors = 0.0
    total = 0.0
    for ipt, tgt in zip(input, target):
        ipt_tokens = ipt.split()
        tgt_tokens = tgt.split()
        errors += _edit_distance(ipt_tokens, tgt_tokens)
        total += len(tgt_tokens)
    return errors, total


def _word_error_rate_compute(
    errors: float, total: float, device: torch.device
) -> torch.Tensor:
    # tensors divide 0/0 to NaN, the value before any update
    return _f32(errors, device) / _f32(total, device)


def word_error_rate(
    input: Union[str, List[str]],
    target: Union[str, List[str]],
    *,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Word error rate of predicted against reference word sequences
    (class version: ``WordErrorRate``). The result lives on ``device``
    (CUDA unless ``device="cpu"``).

    >>> from torcheval_tpu_torch.metrics.functional import word_error_rate
    >>> word_error_rate(["hello world", "welcome to the facebook"],
    ...                 ["hello metaverse", "welcome to meta"], device="cpu")
    tensor(0.6000)
    """
    errors, total = _word_error_rate_update(input, target)
    return _word_error_rate_compute(errors, total, functional_device(device))
