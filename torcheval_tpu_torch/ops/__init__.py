"""Device ops: the fused-AUC histogram and its Hopper kernel, and the
segment, histogram and top-k reductions the counter metrics stand on."""

from torcheval_tpu_torch.ops.fused_auc import (
    DEFAULT_NUM_BINS,
    fused_auc,
    fused_auc_histogram,
    fused_auc_histogram_accumulate,
)
from torcheval_tpu_torch.ops.histogram import bincount, histogram
from torcheval_tpu_torch.ops.segment import segment_count, segment_max, segment_sum
from torcheval_tpu_torch.ops.topk import topk

__all__ = [
    "DEFAULT_NUM_BINS",
    "bincount",
    "fused_auc",
    "fused_auc_histogram",
    "fused_auc_histogram_accumulate",
    "histogram",
    "segment_count",
    "segment_max",
    "segment_sum",
    "topk",
]
