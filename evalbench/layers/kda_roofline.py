"""The KDA scan's share of its roofline, percent: the least time of every
KDA layer's scan in the profiled steps (the larger of the chunked scan's
FLOPs at the bf16 peak and its bytes, q, k, v, g, beta in and o out, at
the HBM peak, ``roofline_kimi_linear.kda_scan_least_s``) over the device
time launched inside ``torcheval.kda.scan``."""

from evalbench import roofline, roofline_kimi_linear


def read(record):
    spans, c = record.get("model_spans"), record.get("config") or {}
    if not spans or "linear_attn_config" not in c:
        return None
    measured = spans["range_device_s"].get("torcheval.kda.scan")
    if not measured:
        return None
    layers = len(c["linear_attn_config"]["kda_layers"])
    least = spans["steps"] * layers * roofline_kimi_linear.kda_scan_least_s(
        c, record["window"], batch=record["windows_per_step"])
    return roofline.share_pct(least, measured)
