"""Perplexity (counterpart of
``torcheval_tpu/metrics/functional/text/perplexity.py``).

One update is ``log_softmax`` over the vocabulary, a gather of each
target's log-probability and a masked sum: linear memory, no host sync.

- **Out-of-range targets.** The JAX package gathers with
  ``take_along_axis(..., mode="clip")``, which wraps a negative target
  once from the end (``-1`` reads the last class) and then clamps into
  ``[0, V-1]``: below ``-V`` reads class 0, ``V`` and past it the last
  class. ``_clip_index`` gives the same index before ``torch.gather``,
  which raises on an out-of-range index on the CPU and trips a device
  assert on CUDA. ``ignore_index`` tokens (Hugging Face's ``-100``) are
  read like any other target, then masked out of the sum and the count.
- **Half precision.** ``jax.nn.log_softmax`` is a sequence of ops (max,
  subtract, exp, sum, log, subtract) that XLA rounds to the input dtype
  after each; torch's fused ``log_softmax`` rounds once. A float16 or
  bfloat16 input therefore takes the same op sequence here, each op
  rounding to the input dtype (the sums accumulate in float32, as
  ``jnp.sum`` does for them). The batch sum stays in the input dtype;
  divided by the int32 count it gives a float32 perplexity.

Under ``config.debug_validation`` a target past the vocabulary raises
(the check reads the targets back to the host). Not ported: the
mask-aware twin (shape bucketing) and the native CPU cross-entropy kernel
(torch ops take its place).
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
    to_torch_float,
)

_HALF = (torch.float16, torch.bfloat16)


def _log_softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_softmax`` over the last axis, rounding where XLA does."""
    if x.dtype not in _HALF:
        return torch.log_softmax(x, dim=-1)
    shifted = x - torch.amax(x, dim=-1, keepdim=True)
    return shifted - torch.log(torch.sum(torch.exp(shifted), dim=-1, keepdim=True))


def _clip_index(target: torch.Tensor, vocab: int) -> torch.Tensor:
    """``take_along_axis(mode="clip")``'s index: negatives wrap once, then
    everything clamps into ``[0, vocab - 1]`` (int64, for gather)."""
    target = target.to(torch.int64)
    wrapped = torch.where(target < 0, target + vocab, target)
    return torch.clamp(wrapped, 0, vocab - 1)


def _perplexity_update_jit(
    input: torch.Tensor,
    target: torch.Tensor,
    ignore_index: Optional[int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Summed negative log-likelihood (in the input's dtype) and the int32
    count of the targets that are not ignored."""
    vocab = input.shape[-1]
    log_probs = _log_softmax(input.reshape(-1, vocab))
    flat_target = target.reshape(-1)
    index = _clip_index(flat_target, vocab)
    token_log_probs = torch.gather(log_probs, 1, index[:, None]).squeeze(-1)
    if ignore_index is not None:
        keep = flat_target != ignore_index
        token_log_probs = torch.where(keep, token_log_probs, 0.0)
        num_total = torch.sum(keep).to(torch.int32)
    else:
        num_total = torch.tensor(
            flat_target.shape[0], dtype=torch.int32, device=flat_target.device
        )
    return -torch.sum(token_log_probs), num_total


def _perplexity_compute(
    sum_log_probs: torch.Tensor, num_total: torch.Tensor
) -> torch.Tensor:
    return torch.exp(sum_log_probs / num_total.to(torch.float32))


def _perplexity_input_check(
    input: torch.Tensor, target: torch.Tensor, ignore_index: Optional[int] = None
) -> None:
    if target.ndim != 2:
        raise ValueError(
            f"target should be a two-dimensional tensor, got shape "
            f"{tuple(target.shape)}."
        )
    if input.ndim != 3:
        raise ValueError(
            f"input should be a three-dimensional tensor, got shape "
            f"{tuple(input.shape)}."
        )
    if input.shape[0] != target.shape[0]:
        raise ValueError(
            "The `input` and `target` should have the same first dimension "
            f"(i.e., batch size), got shapes {tuple(input.shape)} and "
            f"{tuple(target.shape)} instead."
        )
    if input.shape[1] != target.shape[1]:
        raise ValueError(
            "The `input` and `target` should have the same second dimension "
            f"(i.e., sequence length), got shapes {tuple(input.shape)} and "
            f"{tuple(target.shape)} instead."
        )
    if debug_validation_enabled():
        # a host readback, debug-tier only (the reference checks eagerly)
        checked = target
        if ignore_index is not None:
            checked = torch.where(target == ignore_index, 0, target)
        max_label = int(torch.max(checked))
        if input.shape[2] <= max_label:
            raise ValueError(
                "Class labels in `target` tensor cannot be larger than "
                f"vocab_size minus one, got vocab size of {input.shape[2]} "
                f"and target label of {max_label}."
            )


def _perplexity_inputs(input, target, device: torch.device):
    """Logits as floats and targets as integers on ``device``, 64-bit
    dtypes narrowed as the JAX package's arrays hold them."""
    return (
        narrow_64(to_torch_float(input, device=device)),
        narrow_64(to_torch(target, device=device)),
    )


def perplexity(
    input,
    target,
    ignore_index: Optional[int] = None,
    *,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Perplexity: ``exp(sum of negative log-likelihood / number of
    tokens)`` (class version: ``Perplexity``).

    Args:
        input: logits, shape (n_samples, seq_len, vocab_size).
        target: vocabulary indices, shape (n_samples, seq_len).
        ignore_index: target tokens with this value are left out.
        device: where to compute (the inputs' device, else CUDA).

    >>> import torch
    >>> from torcheval_tpu_torch.metrics.functional import perplexity
    >>> input = torch.tensor([[[0.3659, 0.7025, 0.3104], [0.0097, 0.6577, 0.1947]]])
    >>> perplexity(input, torch.tensor([[2, 1]]))
    tensor(2.7593)
    """
    input, target = _perplexity_inputs(
        input, target, functional_device(device, input, target)
    )
    _perplexity_input_check(input, target, ignore_index)
    sum_log_probs, num_total = _perplexity_update_jit(input, target, ignore_index)
    return _perplexity_compute(sum_log_probs, num_total)
