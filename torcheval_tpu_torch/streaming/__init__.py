"""Streaming generative eval: O(1) decode-step metrics (counterpart of
``torcheval_tpu/streaming``).

Token-streaming quality metrics that take ONE decode step at a time and
carry constant-size state:

- :class:`StreamingPerplexity`: running NLL sum and token count.
- :class:`StreamingTokenAccuracy` / :class:`StreamingTokenEditStats`:
  positional substitution/insertion/deletion counters against a
  reference stream.
- :class:`StreamingNgramOverlap`: a bounded n-gram tail and hashed
  clipped-match count planes, the BLEU precision core without sequence
  storage.

Each is a standard ``Metric``, so sync, elastic snapshots and shape
bucketing apply unchanged. For many concurrent streams keyed by request
id, use :class:`StreamTable` (``torcheval_tpu_torch.table.streaming``).
"""

from torcheval_tpu_torch.streaming.edit import (
    StreamingTokenAccuracy,
    StreamingTokenEditStats,
    TokenEditStats,
)
from torcheval_tpu_torch.streaming.ngram import NgramOverlap, StreamingNgramOverlap
from torcheval_tpu_torch.streaming.perplexity import StreamingPerplexity

__all__ = [
    "NgramOverlap",
    "StreamTable",
    "StreamingNgramOverlap",
    "StreamingPerplexity",
    "StreamingTokenAccuracy",
    "StreamingTokenEditStats",
    "TokenEditStats",
]


def __getattr__(name):
    # lazy: table.streaming imports streaming._mix, so an eager import here
    # would be circular whenever table.streaming loads first
    if name == "StreamTable":
        from torcheval_tpu_torch.table.streaming import StreamTable

        return StreamTable
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
