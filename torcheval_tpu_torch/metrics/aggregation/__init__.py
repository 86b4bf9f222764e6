"""Aggregation class metrics."""

from torcheval_tpu_torch.metrics.aggregation.mean import Mean
from torcheval_tpu_torch.metrics.aggregation.sum import Sum
from torcheval_tpu_torch.metrics.aggregation.throughput import Throughput

__all__ = ["Mean", "Sum", "Throughput"]
