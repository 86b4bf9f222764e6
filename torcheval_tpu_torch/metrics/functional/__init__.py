"""Functional metrics of this slice of the port."""

from torcheval_tpu_torch.metrics.functional.aggregation import mean, sum
from torcheval_tpu_torch.metrics.functional.classification import (
    binary_accuracy,
    binary_f1_score,
    multiclass_accuracy,
    multiclass_f1_score,
)

__all__ = [
    "binary_accuracy",
    "binary_f1_score",
    "mean",
    "multiclass_accuracy",
    "multiclass_f1_score",
    "sum",
]
