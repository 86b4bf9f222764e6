"""The eval step's share of the card's bf16 dense peak, percent: the
analytic FLOPs of one step's forward (``roofline.lm_forward_flops``,
causal attention) over the median step time to its synchronize."""

import statistics

from evalbench import roofline, traffic


def read(record):
    times = record.get("step_s")
    if not times:
        return None
    c = record["config"]
    flops = roofline.lm_forward_flops(c["vocab_size"], c["n_embd"], traffic.d_ff(c), c["n_layer"],
                                      record["window"], batch=record["windows_per_step"])
    return roofline.share_pct(flops / roofline.BF16_PEAK_FLOPS, statistics.median(times))
