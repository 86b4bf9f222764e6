"""Throughput, items processed per second (counterpart of
``torcheval_tpu/metrics/functional/aggregation/throughput.py``). Host-side
floats: timing never belongs on the card."""

from __future__ import annotations


def _throughput_param_check(num_processed: int, elapsed_time_sec: float) -> None:
    if num_processed < 0:
        raise ValueError(
            "Expected num_processed to be a non-negative number, but received "
            f"{num_processed}."
        )
    if elapsed_time_sec <= 0:
        raise ValueError(
            "Expected elapsed_time_sec to be a positive number, but received "
            f"{elapsed_time_sec}."
        )


def throughput(num_processed: int = 0, elapsed_time_sec: float = 0.0) -> float:
    """Number of items processed per second (class version: ``Throughput``).

    >>> from torcheval_tpu_torch.metrics.functional import throughput
    >>> throughput(64, 2.0)
    32.0
    """
    _throughput_param_check(num_processed, elapsed_time_sec)
    return num_processed / elapsed_time_sec
