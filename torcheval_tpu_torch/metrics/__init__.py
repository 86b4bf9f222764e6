"""Class metrics of the port: the eval-loop counters and aggregations,
the exact curve family over growable buffers, and the streaming AUCs."""

from torcheval_tpu_torch.metrics.aggregation import Mean, Sum, Throughput
from torcheval_tpu_torch.metrics.classification import (
    BinaryAccuracy,
    BinaryAUPRC,
    BinaryAUROC,
    BinaryF1Score,
    BinaryPrecisionRecallCurve,
    BinaryRecallAtFixedPrecision,
    MulticlassAccuracy,
    MulticlassAUPRC,
    MulticlassAUROC,
    MulticlassF1Score,
    MulticlassPrecisionRecallCurve,
    MultilabelAUPRC,
    MultilabelPrecisionRecallCurve,
    MultilabelRecallAtFixedPrecision,
    StreamingBinaryAUPRC,
    StreamingBinaryAUROC,
)
from torcheval_tpu_torch.metrics.metric import MergeKind, Metric, UpdatePlan

__all__ = [
    "BinaryAccuracy",
    "BinaryAUPRC",
    "BinaryAUROC",
    "BinaryF1Score",
    "BinaryPrecisionRecallCurve",
    "BinaryRecallAtFixedPrecision",
    "Mean",
    "MergeKind",
    "Metric",
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
    "Sum",
    "Throughput",
    "UpdatePlan",
]
