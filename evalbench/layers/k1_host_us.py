"""Host microseconds of one call of K1's wrapper (``_as_2d``, the checks,
``contiguous`` and the dispatcher op's call): median over the spans
window's ``torcheval.k1`` spans."""

import statistics


def read(record):
    spans = (record or {}).get("spans")
    times = [us for b in (spans or {}).get("batches", ()) for us in b["k1_us"]]
    return statistics.median(times) if times else None
