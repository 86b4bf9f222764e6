"""Classification class metrics."""

from torcheval_tpu_torch.metrics.classification.accuracy import (
    BinaryAccuracy,
    MulticlassAccuracy,
)
from torcheval_tpu_torch.metrics.classification.f1_score import (
    BinaryF1Score,
    MulticlassF1Score,
)
from torcheval_tpu_torch.metrics.classification.streaming_auroc import (
    StreamingBinaryAUPRC,
    StreamingBinaryAUROC,
)

__all__ = [
    "BinaryAccuracy",
    "BinaryF1Score",
    "MulticlassAccuracy",
    "MulticlassF1Score",
    "StreamingBinaryAUPRC",
    "StreamingBinaryAUROC",
]
