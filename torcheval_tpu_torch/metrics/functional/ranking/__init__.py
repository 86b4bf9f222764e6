"""Functional ranking and recommendation metrics."""

from torcheval_tpu_torch.metrics.functional.ranking.click_through_rate import (
    click_through_rate,
)
from torcheval_tpu_torch.metrics.functional.ranking.frequency import frequency_at_k
from torcheval_tpu_torch.metrics.functional.ranking.hit_rate import hit_rate
from torcheval_tpu_torch.metrics.functional.ranking.num_collisions import num_collisions
from torcheval_tpu_torch.metrics.functional.ranking.reciprocal_rank import reciprocal_rank
from torcheval_tpu_torch.metrics.functional.ranking.retrieval_precision import (
    retrieval_precision,
)
from torcheval_tpu_torch.metrics.functional.ranking.weighted_calibration import (
    weighted_calibration,
)

__all__ = [
    "click_through_rate",
    "frequency_at_k",
    "hit_rate",
    "num_collisions",
    "reciprocal_rank",
    "retrieval_precision",
    "weighted_calibration",
]
