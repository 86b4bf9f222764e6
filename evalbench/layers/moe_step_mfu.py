"""The MLA + MoE eval step's share of the card's bf16 dense peak, percent:
the analytic FLOPs of one step's forward (``roofline_mla_moe.forward_flops``:
every projection, 6 routed and the shared experts a token, the router, the
head, causal attention at its two head sizes) over the median step time to
its synchronize."""

import statistics

from evalbench import roofline, roofline_mla_moe


def read(record):
    times, c = record.get("step_s"), record.get("config") or {}
    if not times or "kv_lora_rank" not in c:
        return None
    flops = roofline_mla_moe.forward_flops(c, record["window"], batch=record["windows_per_step"])
    return roofline.share_pct(flops / roofline.BF16_PEAK_FLOPS, statistics.median(times))
