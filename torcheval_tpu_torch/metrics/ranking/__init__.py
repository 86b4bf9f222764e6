"""Ranking and recommendation class metrics."""

from torcheval_tpu_torch.metrics.ranking.click_through_rate import ClickThroughRate
from torcheval_tpu_torch.metrics.ranking.hit_rate import HitRate
from torcheval_tpu_torch.metrics.ranking.reciprocal_rank import ReciprocalRank
from torcheval_tpu_torch.metrics.ranking.retrieval_precision import RetrievalPrecision
from torcheval_tpu_torch.metrics.ranking.weighted_calibration import WeightedCalibration

__all__ = [
    "ClickThroughRate",
    "HitRate",
    "ReciprocalRank",
    "RetrievalPrecision",
    "WeightedCalibration",
]
