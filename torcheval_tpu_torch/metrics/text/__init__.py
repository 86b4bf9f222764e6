"""Text class metrics: perplexity, BLEU, and the word error family."""

from torcheval_tpu_torch.metrics.text.bleu import BLEUScore
from torcheval_tpu_torch.metrics.text.perplexity import Perplexity
from torcheval_tpu_torch.metrics.text.word_error_rate import WordErrorRate
from torcheval_tpu_torch.metrics.text.word_information_lost import (
    WordInformationLost,
)
from torcheval_tpu_torch.metrics.text.word_information_preserved import (
    WordInformationPreserved,
)

__all__ = [
    "BLEUScore",
    "Perplexity",
    "WordErrorRate",
    "WordInformationLost",
    "WordInformationPreserved",
]
