"""Functional text metrics: perplexity, BLEU, and the word error family."""

from torcheval_tpu_torch.metrics.functional.text.bleu import bleu_score
from torcheval_tpu_torch.metrics.functional.text.perplexity import perplexity
from torcheval_tpu_torch.metrics.functional.text.word_error_rate import (
    word_error_rate,
)
from torcheval_tpu_torch.metrics.functional.text.word_information_lost import (
    word_information_lost,
)
from torcheval_tpu_torch.metrics.functional.text.word_information_preserved import (
    word_information_preserved,
)

__all__ = [
    "bleu_score",
    "perplexity",
    "word_error_rate",
    "word_information_lost",
    "word_information_preserved",
]
