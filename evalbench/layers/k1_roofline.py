"""K1's share of its roofline, percent: the least time of one launch (its
bytes at the HBM peak, ``roofline.k1_bytes``) over its mean device time in
the profiled sub-window."""

from evalbench import roofline


def read(record):
    trace, sizes = record.get("trace"), record.get("traced_batch_sizes")
    if not trace or not sizes or not record.get("streaming_metrics") or not record.get("num_bins"):
        return None
    times = [dur for name, dur, _ in trace["ops"] if "fused_auc_hist" in name]
    if not times:
        return None
    mean_bytes = sum(roofline.k1_bytes(n, record["num_bins"]) for n in sizes) / len(sizes)
    return roofline.share_pct(mean_bytes / roofline.HBM_BYTES_PER_S, sum(times) / len(times))
