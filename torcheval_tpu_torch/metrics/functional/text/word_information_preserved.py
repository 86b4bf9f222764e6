"""Word information preserved (counterpart of
``torcheval_tpu/metrics/functional/text/word_information_preserved.py``)."""

from __future__ import annotations

from typing import List, Tuple, Union

import torch

from torcheval_tpu_torch.metrics.functional.text.helper import (
    _get_errors_and_totals,
    _text_input_check,
)
from torcheval_tpu_torch.metrics.functional.text.word_error_rate import _f32
from torcheval_tpu_torch.utils.convert import DeviceLike, functional_device


def _word_information_preserved_update(
    input: Union[str, List[str]],
    target: Union[str, List[str]],
) -> Tuple[float, float, float]:
    """(correct_total, target_total, input_total) of the batch."""
    _text_input_check(input, target)
    errors, max_total, target_total, input_total = _get_errors_and_totals(
        input, target
    )
    return max_total - errors, target_total, input_total


def _word_information_preserved_compute(
    correct_total: float,
    target_total: float,
    input_total: float,
    device: torch.device,
) -> torch.Tensor:
    correct = _f32(correct_total, device)
    return (correct / _f32(target_total, device)) * (
        correct / _f32(input_total, device)
    )


def word_information_preserved(
    input: Union[str, List[str]],
    target: Union[str, List[str]],
    *,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Word information preserved of predicted against reference word
    sequences (class version: ``WordInformationPreserved``). The result
    lives on ``device`` (CUDA unless ``device="cpu"``).

    >>> from torcheval_tpu_torch.metrics.functional import word_information_preserved
    >>> word_information_preserved(["hello world", "welcome to the facebook"],
    ...                            ["hello metaverse", "welcome to meta"], device="cpu")
    tensor(0.3000)
    """
    correct, target_total, input_total = _word_information_preserved_update(
        input, target
    )
    return _word_information_preserved_compute(
        correct, target_total, input_total, functional_device(device)
    )
