"""Functional aggregation metrics."""

from torcheval_tpu_torch.metrics.functional.aggregation.mean import mean
from torcheval_tpu_torch.metrics.functional.aggregation.sum import sum

__all__ = ["mean", "sum"]
