"""Functional classification metrics."""

from torcheval_tpu_torch.metrics.functional.classification.accuracy import (
    binary_accuracy,
    multiclass_accuracy,
)
from torcheval_tpu_torch.metrics.functional.classification.f1_score import (
    binary_f1_score,
    multiclass_f1_score,
)

__all__ = [
    "binary_accuracy",
    "binary_f1_score",
    "multiclass_accuracy",
    "multiclass_f1_score",
]
