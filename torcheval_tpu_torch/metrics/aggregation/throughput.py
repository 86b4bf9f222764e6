"""Throughput class metric (counterpart of
``torcheval_tpu/metrics/aggregation/throughput.py``). Host-side float
states by design; the merge sums item counts over the MAX of elapsed
times across replicas (replicas run concurrently, so wall time is the
slowest one's)."""

from __future__ import annotations

import logging
from typing import TypeVar

from torcheval_tpu_torch.metrics.metric import MergeKind, Metric
from torcheval_tpu_torch.utils.convert import DeviceLike

_logger: logging.Logger = logging.getLogger(__name__)

TThroughput = TypeVar("TThroughput", bound="Throughput")


class Throughput(Metric[float]):
    """Items processed per second across the job.

    >>> from torcheval_tpu_torch.metrics import Throughput
    >>> Throughput(device="cpu").update(64, 2.0).compute()
    32.0
    """

    def __init__(self, *, device: DeviceLike = None) -> None:
        super().__init__(device=device)
        self._add_state("num_total", 0.0, merge=MergeKind.SUM)
        self._add_state("elapsed_time_sec", 0.0, merge=MergeKind.MAX)

    def update(
        self: TThroughput, num_processed: int, elapsed_time_sec: float
    ) -> TThroughput:
        if num_processed < 0:
            raise ValueError(
                "Expected num_processed to be a non-negative number, but "
                f"received {num_processed}."
            )
        if elapsed_time_sec <= 0:
            raise ValueError(
                "Expected elapsed_time_sec to be a positive number, but "
                f"received {elapsed_time_sec}."
            )
        self.num_total += num_processed
        self.elapsed_time_sec += elapsed_time_sec
        return self

    def compute(self) -> float:
        if not self.elapsed_time_sec:
            _logger.warning("No calls to update() have been made - returning 0.0")
            return 0.0
        return self.num_total / self.elapsed_time_sec
