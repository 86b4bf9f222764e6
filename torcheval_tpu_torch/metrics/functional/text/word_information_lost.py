"""Word information lost (counterpart of
``torcheval_tpu/metrics/functional/text/word_information_lost.py``)."""

from __future__ import annotations

from typing import List, Tuple, Union

import torch

from torcheval_tpu_torch.metrics.functional.text.helper import (
    _get_errors_and_totals,
    _text_input_check,
)
from torcheval_tpu_torch.metrics.functional.text.word_error_rate import _f32
from torcheval_tpu_torch.utils.convert import DeviceLike, functional_device


def _wil_update(
    input: Union[str, List[str]],
    target: Union[str, List[str]],
) -> Tuple[float, float, float]:
    """(correct_total, target_total, input_total) of the batch."""
    _text_input_check(input, target)
    errors, max_total, target_total, input_total = _get_errors_and_totals(
        input, target
    )
    return max_total - errors, target_total, input_total


def _wil_compute(
    correct_total: float,
    target_total: float,
    preds_total: float,
    device: torch.device,
) -> torch.Tensor:
    correct = _f32(correct_total, device)
    return 1 - (
        (correct / _f32(target_total, device)) * (correct / _f32(preds_total, device))
    )


def word_information_lost(
    input: Union[str, List[str]],
    target: Union[str, List[str]],
    *,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Word information lost of transcriptions against references (class
    version: ``WordInformationLost``). The result lives on ``device``
    (CUDA unless ``device="cpu"``).

    >>> from torcheval_tpu_torch.metrics.functional import word_information_lost
    >>> word_information_lost(
    ...     ["this is the prediction", "there is an other sample"],
    ...     ["this is the reference", "there is another one"], device="cpu")
    tensor(0.6528)
    """
    correct_total, target_total, preds_total = _wil_update(input, target)
    return _wil_compute(
        correct_total, target_total, preds_total, functional_device(device)
    )
