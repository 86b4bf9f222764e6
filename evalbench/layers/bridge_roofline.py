"""The metric bridge's share of its roofline, percent: the step's logits
read once and its targets once at the HBM peak (``roofline.bridge_bytes``)
for every traced step, over the device time launched inside
``evalbench.metric_update``."""

from evalbench import roofline


def read(record):
    trace, steps = record.get("trace"), record.get("traced_steps")
    if not trace or not steps:
        return None
    device_s = trace["range_device_s"].get("evalbench.metric_update")
    if not device_s:
        return None
    nbytes = steps * roofline.bridge_bytes(record["tokens_per_step"], record["config"]["vocab_size"])
    return roofline.share_pct(nbytes / roofline.HBM_BYTES_PER_S, device_s)
