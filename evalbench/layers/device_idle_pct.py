"""The card's idle share, percent: one minus the union of device operation
intervals over the length of the profiled sub-window."""


def read(record):
    trace = record.get("trace")
    if not trace or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
