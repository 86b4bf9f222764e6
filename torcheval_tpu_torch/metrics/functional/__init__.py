"""Functional metrics of the port."""

from torcheval_tpu_torch.metrics.functional.aggregation import mean, sum
from torcheval_tpu_torch.metrics.functional.classification import (
    binary_accuracy,
    binary_auprc,
    binary_auroc,
    binary_f1_score,
    binary_precision_recall_curve,
    binary_recall_at_fixed_precision,
    multiclass_accuracy,
    multiclass_auprc,
    multiclass_auroc,
    multiclass_f1_score,
    multiclass_precision_recall_curve,
    multilabel_auprc,
    multilabel_precision_recall_curve,
    multilabel_recall_at_fixed_precision,
)

__all__ = [
    "binary_accuracy",
    "binary_auprc",
    "binary_auroc",
    "binary_f1_score",
    "binary_precision_recall_curve",
    "binary_recall_at_fixed_precision",
    "mean",
    "multiclass_accuracy",
    "multiclass_auprc",
    "multiclass_auroc",
    "multiclass_f1_score",
    "multiclass_precision_recall_curve",
    "multilabel_auprc",
    "multilabel_precision_recall_curve",
    "multilabel_recall_at_fixed_precision",
    "sum",
]
