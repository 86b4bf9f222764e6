"""Device milliseconds of one pass-end compute of a panel of buffered
(exact) curve metrics: in the profiled sub-window, which holds a pass end,
the first device operation launched inside ``evalbench.compute`` to the
end of its last, median over the entries of that range."""

import statistics

from evalbench.trace import extents


def read(record):
    times = extents(record.get("trace"), "evalbench.compute")
    if not record.get("buffered_metrics") or not times:
        return None
    return statistics.median(times) * 1e3
