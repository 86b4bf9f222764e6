"""Device ops: the fused-AUC histogram and its Hopper kernel."""

from torcheval_tpu_torch.ops.fused_auc import (
    DEFAULT_NUM_BINS,
    fused_auc,
    fused_auc_histogram,
    fused_auc_histogram_accumulate,
)

__all__ = [
    "DEFAULT_NUM_BINS",
    "fused_auc",
    "fused_auc_histogram",
    "fused_auc_histogram_accumulate",
]
