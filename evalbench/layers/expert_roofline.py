"""The routed experts' share of their roofline, percent: the least time of
their work in the profiled steps (the larger of the grouped products'
FLOPs at the bf16 peak and the expert weights plus the routed tokens in
and out at the HBM peak, ``roofline_mla_moe.expert_least_s``) over the
device time launched inside ``torcheval.moe.experts``."""

from evalbench import roofline, roofline_mla_moe


def read(record):
    spans, c = record.get("model_spans"), record.get("config") or {}
    if not spans or "n_routed_experts" not in c:
        return None
    measured = spans["range_device_s"].get("torcheval.moe.experts")
    if not measured:
        return None
    least = spans["steps"] * roofline_mla_moe.expert_least_s(c, record["tokens_per_step"])
    return roofline.share_pct(least, measured)
