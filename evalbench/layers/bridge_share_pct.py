"""The metric bridge's share of the eval step's device time, percent:
device time launched inside the ``evalbench.metric_update`` range over
that launched inside ``evalbench.step``, in the profiled sub-window."""


def read(record):
    trace = record.get("trace")
    if not trace:
        return None
    per = trace["range_device_s"]
    bridge, step = per.get("evalbench.metric_update"), per.get("evalbench.step")
    if not bridge or not step:
        return None
    return 100.0 * bridge / step
