"""Median host microseconds of one batch's panel update
(``update_collection`` for every input set of the panel), on the
benchmark's clock: the time the eval thread is held by the metric core
and the toolkit."""

import statistics


def read(record):
    times = record.get("panel_update_us")
    return statistics.median(times) if times else None
