"""Streaming perplexity: one decode step at a time, O(1) state
(counterpart of ``torcheval_tpu/streaming/perplexity.py``).

The decode loop hands over the log-probability the model assigned to each
token as it is sampled, and the metric carries two scalars: the running
negative-log-likelihood sum and the token count.

Bit-identity: the update folds the step's tokens into the NLL state one
after another (``((nll - lp0) - lp1) ...``, float32), so feeding a
sequence token by token and feeding it as one array run the same chain of
adds: step-by-step ``compute()`` equals the whole-sequence value bitwise.
torch has no sequential float scan (``cumsum`` accumulates in double on
the CPU and in a tree on CUDA), so the fold is a loop over the step's
tokens: one add a token, which a decode step (one token, or a few under
speculative decoding) keeps short. The masked twin (shape bucketing)
passes the carry through unchanged on padded rows (a select, not an
add of zero).
"""

from __future__ import annotations

from typing import TypeVar

import torch

from torcheval_tpu_torch.metrics.functional.text.perplexity import _perplexity_compute
from torcheval_tpu_torch.metrics.metric import MergeKind, Metric, UpdatePlan
from torcheval_tpu_torch.utils.convert import DeviceLike

TStreamingPerplexity = TypeVar("TStreamingPerplexity", bound="StreamingPerplexity")

__all__ = ["StreamingPerplexity"]


def _stream_ppl_kernel(states, log_probs):
    nll, count = states
    for i in range(log_probs.shape[0]):
        nll = nll + (-log_probs[i])
    return nll, count + log_probs.shape[0]


def _stream_ppl_kernel_masked(states, log_probs, valid):
    nll, count = states
    for i in range(log_probs.shape[0]):
        # select, not add-zero: padded slots leave the carry bit-identical
        # (adding -0.0 would not)
        nll = torch.where(i < valid[0], nll + (-log_probs[i]), nll)
    return nll, count + valid[0]


class StreamingPerplexity(Metric[torch.Tensor]):
    """exp(NLL sum / token count) over a token stream fed step by step.

    ``update`` takes the per-token log-probabilities of ONE decode step: a
    scalar for a single sampled token, or a 1-D tensor when several tokens
    land at once. Any shape is flattened; the fold order is the flattened
    order.

    >>> from torcheval_tpu_torch.streaming import StreamingPerplexity
    >>> metric = StreamingPerplexity(device="cpu")
    >>> for lp in [-0.1, -2.3, -0.7]:   # one decode step at a time
    ...     _ = metric.update(lp)
    >>> metric.compute()
    tensor(2.8104)
    """

    _bucketed_update = True

    def __init__(self, *, device: DeviceLike = None) -> None:
        super().__init__(device=device)
        self._add_state("sum_log_probs", torch.zeros(()), merge=MergeKind.SUM)
        # exact int32 token counter (float32 would saturate at 2^24)
        self._add_state("num_total", torch.zeros((), dtype=torch.int32), merge=MergeKind.SUM)

    def update(self: TStreamingPerplexity, token_log_probs) -> TStreamingPerplexity:
        """Fold one decode step (scalar or tensor of per-token log-probs)."""
        return self._apply_update_plan(self._update_plan(token_log_probs))

    def _update_plan(self, token_log_probs):
        lp = self._input_float(token_log_probs).to(torch.float32).reshape(-1)
        return UpdatePlan(
            _stream_ppl_kernel,
            ("sum_log_probs", "num_total"),
            (lp,),
            transform=True,
            masked_kernel=_stream_ppl_kernel_masked,
            batch_axes=(("n",),),
        )

    def compute(self) -> torch.Tensor:
        """Running perplexity over every token folded so far."""
        return _perplexity_compute(self.sum_log_probs, self.num_total)
