"""Host microseconds a batch spends building the panel's update plans:
median over the spans window's batches of the summed
``torcheval.plan/<Metric>`` spans (input validation, conversion through
the shared conversion cache, padding), one a metric with a plan."""

from evalbench.spans import batch_median_us


def read(record):
    return batch_median_us(record, lambda name: name.startswith("torcheval.plan/"))
