"""Windowed metrics: values over the last updates (or samples) of a
stream, kept in ring buffers, with optional lifetime values beside them."""

from torcheval_tpu_torch.metrics.window.auroc import WindowedBinaryAUROC
from torcheval_tpu_torch.metrics.window.click_through_rate import WindowedClickThroughRate
from torcheval_tpu_torch.metrics.window.mean_squared_error import WindowedMeanSquaredError
from torcheval_tpu_torch.metrics.window.normalized_entropy import (
    WindowedBinaryNormalizedEntropy,
)
from torcheval_tpu_torch.metrics.window.weighted_calibration import (
    WindowedWeightedCalibration,
)

__all__ = [
    "WindowedBinaryAUROC",
    "WindowedBinaryNormalizedEntropy",
    "WindowedClickThroughRate",
    "WindowedMeanSquaredError",
    "WindowedWeightedCalibration",
]
