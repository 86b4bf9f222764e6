"""Per-layer metric readers, one file a metric, named as the metric (a
dotted name without a file of its own reads with the file of its first
part: ``device_idle_pct.lm`` with ``device_idle_pct.py``).

Each has ``read(record) -> float | None``. ``record`` is what the traced
run kept: the eval loop's own entries (host timings, step times,
counts, shapes) and under ``"trace"`` the reduced profile of the traced
sub-window (``evalbench.trace.reduce_trace``), or None when no trace held
a kernel. A reader that finds nothing to read returns None, never 0.
"""
