"""Functional classification metrics."""

from torcheval_tpu_torch.metrics.functional.classification.accuracy import (
    binary_accuracy,
    multiclass_accuracy,
)
from torcheval_tpu_torch.metrics.functional.classification.auprc import (
    binary_auprc,
    multiclass_auprc,
    multilabel_auprc,
)
from torcheval_tpu_torch.metrics.functional.classification.auroc import (
    binary_auroc,
    multiclass_auroc,
)
from torcheval_tpu_torch.metrics.functional.classification.f1_score import (
    binary_f1_score,
    multiclass_f1_score,
)
from torcheval_tpu_torch.metrics.functional.classification.precision_recall_curve import (
    binary_precision_recall_curve,
    multiclass_precision_recall_curve,
    multilabel_precision_recall_curve,
)
from torcheval_tpu_torch.metrics.functional.classification.recall_at_fixed_precision import (
    binary_recall_at_fixed_precision,
    multilabel_recall_at_fixed_precision,
)

__all__ = [
    "binary_accuracy",
    "binary_auprc",
    "binary_auroc",
    "binary_f1_score",
    "binary_precision_recall_curve",
    "binary_recall_at_fixed_precision",
    "multiclass_accuracy",
    "multiclass_auprc",
    "multiclass_auroc",
    "multiclass_f1_score",
    "multiclass_precision_recall_curve",
    "multilabel_auprc",
    "multilabel_precision_recall_curve",
    "multilabel_recall_at_fixed_precision",
]
