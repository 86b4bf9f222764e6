"""The exact curve compute's share of its roofline, percent: each buffered
metric's scores and labels of one pass read once at the HBM peak
(``roofline.curve_bytes``), over the pass-end compute's device time as
``curve_compute_ms`` reads it."""

import statistics

from evalbench import roofline
from evalbench.trace import extents


def read(record):
    times, k = extents(record.get("trace"), "evalbench.compute"), record.get("buffered_metrics")
    if not k or not times:
        return None
    least = roofline.curve_bytes(record["pass_samples"], k) / roofline.HBM_BYTES_PER_S
    return roofline.share_pct(least, statistics.median(times))
