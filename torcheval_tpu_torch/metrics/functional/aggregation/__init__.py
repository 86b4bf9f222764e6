"""Functional aggregation metrics."""

from torcheval_tpu_torch.metrics.functional.aggregation.auc import auc
from torcheval_tpu_torch.metrics.functional.aggregation.mean import mean
from torcheval_tpu_torch.metrics.functional.aggregation.sum import sum
from torcheval_tpu_torch.metrics.functional.aggregation.throughput import throughput

__all__ = ["auc", "mean", "sum", "throughput"]
