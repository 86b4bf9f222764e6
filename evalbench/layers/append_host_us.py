"""Host microseconds a batch spends appending to the example buffers:
median over the spans window's batches of the summed
``torcheval.update/<Metric>`` spans of the panel's buffered metrics
(``record["buffered_classes"]``), growth copies included."""

from evalbench.spans import batch_median_us


def read(record):
    names = {f"torcheval.update/{c}" for c in (record or {}).get("buffered_classes") or ()}
    if not names:
        return None
    return batch_median_us(record, names.__contains__)
