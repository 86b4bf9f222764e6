"""Host microseconds a batch spends enqueueing the panel's state kernels:
median over the spans window's batches of the summed
``torcheval.accumulate/<Metric>`` spans (a graphed group's
``torcheval.replay``), K1's wrapper inside them included."""

from evalbench.spans import batch_median_us


def read(record):
    return batch_median_us(record, lambda name: name.startswith("torcheval.accumulate/")
                           or name == "torcheval.replay")
