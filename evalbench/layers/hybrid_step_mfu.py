"""The hybrid (KDA + MLA + MoE) eval step's share of the card's bf16 dense
peak, percent: ``record["step_flops"]``, the analytic FLOPs of one step's
forward (``roofline_kimi_linear.forward_flops``: every projection, the
held share of the routed experts, the shared expert, the router, the head,
the KDA scans and MLA's causal products), over the median step time to its
synchronize."""

import statistics

from evalbench import roofline


def read(record):
    times, flops = record.get("step_s"), record.get("step_flops")
    if not times or not flops:
        return None
    return roofline.share_pct(flops / roofline.BF16_PEAK_FLOPS, statistics.median(times))
