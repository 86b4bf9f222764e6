"""Classification class metrics."""

from torcheval_tpu_torch.metrics.classification.accuracy import (
    BinaryAccuracy,
    MulticlassAccuracy,
)
from torcheval_tpu_torch.metrics.classification.auprc import (
    BinaryAUPRC,
    MulticlassAUPRC,
    MultilabelAUPRC,
)
from torcheval_tpu_torch.metrics.classification.auroc import BinaryAUROC, MulticlassAUROC
from torcheval_tpu_torch.metrics.classification.f1_score import (
    BinaryF1Score,
    MulticlassF1Score,
)
from torcheval_tpu_torch.metrics.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
)
from torcheval_tpu_torch.metrics.classification.recall_at_fixed_precision import (
    BinaryRecallAtFixedPrecision,
    MultilabelRecallAtFixedPrecision,
)
from torcheval_tpu_torch.metrics.classification.streaming_auroc import (
    StreamingBinaryAUPRC,
    StreamingBinaryAUROC,
)

__all__ = [
    "BinaryAccuracy",
    "BinaryAUPRC",
    "BinaryAUROC",
    "BinaryF1Score",
    "BinaryPrecisionRecallCurve",
    "BinaryRecallAtFixedPrecision",
    "MulticlassAccuracy",
    "MulticlassAUPRC",
    "MulticlassAUROC",
    "MulticlassF1Score",
    "MulticlassPrecisionRecallCurve",
    "MultilabelAUPRC",
    "MultilabelPrecisionRecallCurve",
    "MultilabelRecallAtFixedPrecision",
    "StreamingBinaryAUPRC",
    "StreamingBinaryAUROC",
]
