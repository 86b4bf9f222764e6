"""Streaming token-edit counters: the aligned WER/CER core, O(1) state
(counterpart of ``torcheval_tpu/streaming/edit.py``).

Each ``update`` takes the hypothesis token(s) of ONE decode step and the
reference token(s) aligned to the same position(s), and bumps six int32
counters: matches, substitutions, insertions, deletions, hypothesis
tokens, reference tokens. The alignment is POSITIONAL (teacher-forced or
same-length streams); ``-1`` on either side marks "no token at this step",
so a hypothesis that runs past its reference accrues insertions and one
that stops short accrues deletions.

Integer adds are associative, so step-by-step feeding, whole-sequence
feeding, bucketed padding and any merge order give the same counters.
"""

from __future__ import annotations

from typing import NamedTuple, TypeVar

import torch

from torcheval_tpu_torch.metrics.metric import MergeKind, Metric, UpdatePlan
from torcheval_tpu_torch.utils.convert import DeviceLike

TTokenEdit = TypeVar("TTokenEdit", bound="_StreamingTokenEditBase")

__all__ = ["StreamingTokenAccuracy", "StreamingTokenEditStats", "TokenEditStats"]

_STATE_NAMES = (
    "matches",
    "substitutions",
    "insertions",
    "deletions",
    "num_hyp_tokens",
    "num_ref_tokens",
)


class TokenEditStats(NamedTuple):
    """``StreamingTokenEditStats.compute()`` result (0-d tensors)."""

    error_rate: torch.Tensor
    matches: torch.Tensor
    substitutions: torch.Tensor
    insertions: torch.Tensor
    deletions: torch.Tensor
    num_hyp_tokens: torch.Tensor
    num_ref_tokens: torch.Tensor


def _edit_counts(hyp, ref, live):
    hyp_valid = (hyp >= 0) & live
    ref_valid = (ref >= 0) & live
    both = hyp_valid & ref_valid

    def count(m):
        return torch.sum(m, dtype=torch.int32)

    return (
        count(both & (hyp == ref)),
        count(both & (hyp != ref)),
        count(hyp_valid & ~ref_valid),
        count(ref_valid & ~hyp_valid),
        count(hyp_valid),
        count(ref_valid),
    )


def _edit_update_kernel(hyp, ref):
    return _edit_counts(hyp, ref, torch.ones(hyp.shape, dtype=torch.bool, device=hyp.device))


def _edit_update_kernel_masked(hyp, ref, valid):
    return _edit_counts(hyp, ref, torch.arange(hyp.shape[0], device=hyp.device) < valid[0])


def _aligned_tokens(metric, step_tokens, ref_tokens, what: str):
    """The step's hypothesis and reference tokens as aligned int32 rows
    (``None`` reference: all ``-1``)."""
    hyp = metric._input(step_tokens, dtype=torch.int32).reshape(-1)
    if ref_tokens is None:
        ref = torch.full(hyp.shape, -1, dtype=torch.int32, device=hyp.device)
    else:
        ref = metric._input(ref_tokens, dtype=torch.int32).reshape(-1)
    if hyp.shape != ref.shape:
        raise ValueError(
            f"step_tokens and ref_tokens must {what} "
            f"(got {tuple(hyp.shape)} vs {tuple(ref.shape)}); pad the shorter "
            "stream with the -1 sentinel."
        )
    return hyp, ref


class _StreamingTokenEditBase(Metric[torch.Tensor]):
    _bucketed_update = True

    def __init__(self, *, device: DeviceLike = None) -> None:
        super().__init__(device=device)
        for name in _STATE_NAMES:
            self._add_state(name, torch.zeros((), dtype=torch.int32), merge=MergeKind.SUM)

    def update(self: TTokenEdit, step_tokens, ref_tokens=None) -> TTokenEdit:
        """Fold one aligned decode step.

        Args:
            step_tokens: hypothesis token id(s), scalar or 1-D; ``-1`` where
                the hypothesis stream has ended.
            ref_tokens: reference token id(s) aligned to the same
                position(s); ``-1`` where the reference has ended. ``None``
                means no reference tokens at these positions (pure
                insertions).
        """
        return self._apply_update_plan(self._update_plan(step_tokens, ref_tokens))

    def _update_plan(self, step_tokens, ref_tokens=None):
        hyp, ref = _aligned_tokens(self, step_tokens, ref_tokens, "align position-for-position")
        return UpdatePlan(
            _edit_update_kernel,
            _STATE_NAMES,
            (hyp, ref),
            masked_kernel=_edit_update_kernel_masked,
            batch_axes=(("n",), ("n",)),
        )


class StreamingTokenAccuracy(_StreamingTokenEditBase):
    """Fraction of reference tokens the hypothesis matched, streamed.

    >>> from torcheval_tpu_torch.streaming import StreamingTokenAccuracy
    >>> metric = StreamingTokenAccuracy(device="cpu")
    >>> for hyp, ref in [(5, 5), (9, 7), (3, 3)]:
    ...     _ = metric.update(hyp, ref)
    >>> metric.compute()
    tensor(0.6667)
    """

    def compute(self) -> torch.Tensor:
        """matches / reference tokens (0.0 before any reference token)."""
        ref = self.num_ref_tokens.to(torch.float32)
        return torch.where(
            ref > 0, self.matches.to(torch.float32) / torch.clamp(ref, min=1.0), 0.0
        )


class StreamingTokenEditStats(_StreamingTokenEditBase):
    """Positional substitution/insertion/deletion counters, streamed.

    ``compute()`` returns the full :class:`TokenEditStats` tuple;
    ``error_rate`` is the WER-style ``(S + I + D) / reference tokens``.
    """

    def compute(self) -> TokenEditStats:
        ref = self.num_ref_tokens.to(torch.float32)
        errors = (self.substitutions + self.insertions + self.deletions).to(torch.float32)
        rate = torch.where(ref > 0, errors / torch.clamp(ref, min=1.0), 0.0)
        return TokenEditStats(
            error_rate=rate,
            matches=self.matches,
            substitutions=self.substitutions,
            insertions=self.insertions,
            deletions=self.deletions,
            num_hyp_tokens=self.num_hyp_tokens,
            num_ref_tokens=self.num_ref_tokens,
        )
