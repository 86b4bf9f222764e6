"""Binary normalized entropy (NE = cross entropy / baseline entropy).

Counterpart of ``torcheval_tpu/metrics/functional/classification/
binary_normalized_entropy.py``. As there, everything stays in float32 --
the upstream reference accumulates in float64, the JAX package does not --
and the baseline clamps the positive rate by the float64 epsilon through
the ``r <-> 1 - r`` symmetry of its entropy (``_baseline_update``), so the
all-positive and all-negative tails stay finite and match.

Probabilities outside ``[0, 1]`` raise only under
``config.debug_validation`` (the check reads the input back to the host);
otherwise the ``[0, 1]`` clip in ``_ne_ce_rows`` keeps them from producing
NaN.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from torcheval_tpu_torch.config import debug_validation_enabled
from torcheval_tpu_torch.utils.convert import (
    DeviceLike,
    functional_device,
    narrow_64,
    to_torch,
)

# the reference clamps the positive rate by the float64 epsilon
_EPS64 = 2.220446049250313e-16


def _ne_ce_rows(
    input: torch.Tensor, target: torch.Tensor, from_logits: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-element cross entropy and the float32 target: the one home of
    the CE formula."""
    target = target.to(torch.float32)
    input = input.to(torch.float32)
    if from_logits:
        # numerically stable BCE-with-logits:
        # max(x, 0) - x * t + log(1 + exp(-|x|))
        return (
            torch.clamp(input, min=0.0)
            - input * target
            + torch.log1p(torch.exp(-torch.abs(input)))
        ), target
    # binary_cross_entropy clamps each log term at -100 (input 0 or 1 costs
    # 100, not inf); the [0, 1] clip keeps an ulp past 1 from taking the log
    # of a negative number
    input = torch.clamp(input, 0.0, 1.0)
    logx = torch.clamp(torch.log(input), min=-100.0)
    log1mx = torch.clamp(torch.log1p(-input), min=-100.0)
    return -(target * logx + (1.0 - target) * log1mx), target


def _ne_update(
    input: torch.Tensor,
    target: torch.Tensor,
    weight: Optional[torch.Tensor],
    from_logits: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(cross_entropy, num_positive, num_examples)`` summed over the
    sample axis (the counterpart of ``_ne_update_jit``)."""
    ce, target = _ne_ce_rows(input, target, from_logits)
    if weight is None:
        return (
            torch.sum(ce, dim=-1),
            torch.sum(target, dim=-1),
            torch.sum(torch.ones_like(target), dim=-1),
        )
    w = weight.to(torch.float32)
    return (
        torch.sum(w * ce, dim=-1),
        torch.sum(w * target, dim=-1),
        torch.sum(w, dim=-1),
    )


def _baseline_update(
    num_positive: torch.Tensor, num_examples: torch.Tensor
) -> torch.Tensor:
    """Entropy of the base positive rate. ``1 - eps64`` is not a float32,
    so the distance to the nearer boundary, ``min(r, 1 - r)``, is clamped
    to ``[eps64, 0.5]`` and the entropy evaluated with ``log1p``: the
    float64-eps clamp of the reference, on both tails, in float32."""
    rate = num_positive / num_examples
    d = torch.clamp(torch.minimum(rate, 1.0 - rate), _EPS64, 0.5)
    return -d * torch.log(d) - (1.0 - d) * torch.log1p(-d)


def _ne_input_check(
    input: torch.Tensor,
    target: torch.Tensor,
    from_logits: bool,
    num_tasks: int,
    weight: Optional[torch.Tensor] = None,
) -> None:
    if input.shape != target.shape:
        raise ValueError(
            f"`input` shape ({input.shape}) is different from `target` shape "
            f"({target.shape})"
        )
    if weight is not None and weight.shape != target.shape:
        raise ValueError(
            f"`weight` shape ({weight.shape}) is different from `target` "
            f"shape ({target.shape})"
        )
    if num_tasks == 1:
        if input.ndim > 1:
            raise ValueError(
                "`num_tasks = 1`, `input` is expected to be one-dimensional "
                f"tensor, but got shape ({input.shape})."
            )
    elif input.ndim == 1 or input.shape[0] != num_tasks:
        raise ValueError(
            f"`num_tasks = {num_tasks}`, `input`'s shape is expected to be "
            f"({num_tasks}, num_samples), but got shape ({input.shape})."
        )
    if not from_logits and debug_validation_enabled():
        if bool(torch.any((input < 0) | (input > 1))):
            raise ValueError(
                "`input` should be probability when from_logits=False, got "
                "values outside [0, 1]."
            )


def _ne_deltas(
    input: torch.Tensor,
    target: torch.Tensor,
    weight: Optional[torch.Tensor],
    from_logits: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-task (1-d) state deltas, in the class's state order
    ``(total_entropy, num_positive, num_examples)``."""
    ce, npos, nex = _ne_update(input, target, weight, from_logits)
    return torch.atleast_1d(ce), torch.atleast_1d(npos), torch.atleast_1d(nex)


def binary_normalized_entropy(
    input,
    target,
    *,
    weight=None,
    num_tasks: int = 1,
    from_logits: bool = False,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Normalized entropy: the cross entropy of the predictions divided by
    the entropy of the base positive rate (class version:
    ``BinaryNormalizedEntropy``).

    >>> import torch
    >>> from torcheval_tpu_torch.metrics.functional import binary_normalized_entropy
    >>> binary_normalized_entropy(torch.tensor([0.2, 0.3]), torch.tensor([1.0, 0.0]))
    tensor(1.4183)
    """
    dev = functional_device(device, input, target, weight)
    input = narrow_64(to_torch(input, device=dev))
    target = narrow_64(to_torch(target, device=dev))
    weight = None if weight is None else narrow_64(to_torch(weight, device=dev))
    _ne_input_check(input, target, from_logits, num_tasks, weight)
    cross_entropy, num_positive, num_examples = _ne_update(
        input, target, weight, from_logits
    )
    return (cross_entropy / num_examples) / _baseline_update(num_positive, num_examples)
