"""Class metrics of this slice of the port (the eval-loop main path)."""

from torcheval_tpu_torch.metrics.aggregation import Mean, Sum, Throughput
from torcheval_tpu_torch.metrics.classification import (
    BinaryAccuracy,
    BinaryF1Score,
    MulticlassAccuracy,
    MulticlassF1Score,
    StreamingBinaryAUPRC,
    StreamingBinaryAUROC,
)
from torcheval_tpu_torch.metrics.metric import MergeKind, Metric, UpdatePlan

__all__ = [
    "BinaryAccuracy",
    "BinaryF1Score",
    "Mean",
    "MergeKind",
    "Metric",
    "MulticlassAccuracy",
    "MulticlassF1Score",
    "StreamingBinaryAUPRC",
    "StreamingBinaryAUROC",
    "Sum",
    "Throughput",
    "UpdatePlan",
]
