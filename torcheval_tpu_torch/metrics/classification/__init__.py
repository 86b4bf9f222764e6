"""Classification class metrics."""

from torcheval_tpu_torch.metrics.classification.accuracy import (
    BinaryAccuracy,
    MulticlassAccuracy,
    MultilabelAccuracy,
    TopKMultilabelAccuracy,
)
from torcheval_tpu_torch.metrics.classification.auprc import (
    BinaryAUPRC,
    MulticlassAUPRC,
    MultilabelAUPRC,
)
from torcheval_tpu_torch.metrics.classification.auroc import (
    BinaryAUROC,
    MulticlassAUROC,
)
from torcheval_tpu_torch.metrics.classification.binned_auprc import (
    BinaryBinnedAUPRC,
    MulticlassBinnedAUPRC,
    MultilabelBinnedAUPRC,
)
from torcheval_tpu_torch.metrics.classification.binned_auroc import (
    BinaryBinnedAUROC,
    HistogramBinnedAUROC,
    MulticlassBinnedAUROC,
)
from torcheval_tpu_torch.metrics.classification.binned_precision_recall_curve import (
    BinaryBinnedPrecisionRecallCurve,
    MulticlassBinnedPrecisionRecallCurve,
    MultilabelBinnedPrecisionRecallCurve,
)
from torcheval_tpu_torch.metrics.classification.binary_normalized_entropy import (
    BinaryNormalizedEntropy,
)
from torcheval_tpu_torch.metrics.classification.confusion_matrix import (
    BinaryConfusionMatrix,
    MulticlassConfusionMatrix,
)
from torcheval_tpu_torch.metrics.classification.f1_score import (
    BinaryF1Score,
    MulticlassF1Score,
)
from torcheval_tpu_torch.metrics.classification.precision import (
    BinaryPrecision,
    MulticlassPrecision,
)
from torcheval_tpu_torch.metrics.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
)
from torcheval_tpu_torch.metrics.classification.recall import (
    BinaryRecall,
    MulticlassRecall,
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
    "BinaryBinnedAUPRC",
    "BinaryBinnedAUROC",
    "BinaryBinnedPrecisionRecallCurve",
    "BinaryConfusionMatrix",
    "BinaryF1Score",
    "BinaryNormalizedEntropy",
    "BinaryPrecision",
    "BinaryPrecisionRecallCurve",
    "BinaryRecall",
    "BinaryRecallAtFixedPrecision",
    "HistogramBinnedAUROC",
    "MulticlassAccuracy",
    "MulticlassAUPRC",
    "MulticlassAUROC",
    "MulticlassBinnedAUPRC",
    "MulticlassBinnedAUROC",
    "MulticlassBinnedPrecisionRecallCurve",
    "MulticlassConfusionMatrix",
    "MulticlassF1Score",
    "MulticlassPrecision",
    "MulticlassPrecisionRecallCurve",
    "MulticlassRecall",
    "MultilabelAccuracy",
    "MultilabelAUPRC",
    "MultilabelBinnedAUPRC",
    "MultilabelBinnedPrecisionRecallCurve",
    "MultilabelPrecisionRecallCurve",
    "MultilabelRecallAtFixedPrecision",
    "StreamingBinaryAUPRC",
    "StreamingBinaryAUROC",
    "TopKMultilabelAccuracy",
]
