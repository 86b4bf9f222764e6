"""The held experts' share of their roofline, percent: the least time of
their work in the profiled steps (the larger of the grouped products'
FLOPs over the pairs routed to a held expert, the ``moe`` counter
source's ``held_pairs`` in those steps, at the bf16 peak, and the held
experts' weights plus those pairs' tokens in and out at the HBM peak,
``roofline_kimi_linear.held_expert_least_s``) over the device time
launched inside ``torcheval.moe.experts``. A layer holding a share of the
experts (``expert_roofline`` counts every expert and every pair)."""

from evalbench import roofline, roofline_kimi_linear


def read(record):
    spans, c = record.get("model_spans"), record.get("config") or {}
    pairs = record.get("model_span_held_pairs")
    if not spans or not pairs or "linear_attn_config" not in c:
        return None
    measured = spans["range_device_s"].get("torcheval.moe.experts")
    if not measured:
        return None
    least = roofline_kimi_linear.held_expert_least_s(c, pairs, spans["steps"])
    return roofline.share_pct(least, measured)
