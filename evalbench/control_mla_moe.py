"""Run an MLA + MoE cell's control: the reference put in the program's
place, one precision below the configuration's, judged by the run's own
numbers (``control.py`` does the same for the other cells).

    python3 evalbench/control_mla_moe.py --workload moonlight16b_eval --seed <n> [--seed <n> ...]

For each seed, one JSON line: each number compared, its limit, and
``control_failed`` (true when at least one number is past its limit, as it
has to be). The control is the forward with every product's operands in
float8 e4m3, the router's included (``reference.mla_moe.forward(...,
fp8_control=True)``), and the perplexity bridge of ``control.py``
(``low_bridge_sum``: the program's op sequence with each op rounded to
float8 where the program rounds to bfloat16, each step's sum rounded to
bfloat16), over the cell's checked steps; the perplexity of their sums
computed in bfloat16. The control has no expert layer of the program, so
``route_count_gap`` is not among its numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from evalbench import mla_moe_weights, spec  # noqa: E402
from evalbench import traffic as gen  # noqa: E402
from evalbench.control import low_bridge_sum  # noqa: E402
from evalbench.reference import compare, mla_moe  # noqa: E402


def mla_moe_control(cell, seed, device) -> dict:
    cfg, tr = cell.config, cell.traffic
    vocab = cfg["vocab_size"]
    weights = mla_moe_weights.weights(cfg, seed, device)
    pool = gen.token_pool(cfg, tr, seed, device)
    steps, total = [], [0.0, 0]
    for k in gen.sample_steps(tr, seed):
        ids = pool[k % pool.shape[0]]
        targets = ids[:, 1:].reshape(-1)
        logits = mla_moe.forward(weights, ids[:, :-1], cfg, fp8_control=True).reshape(-1, vocab)
        n = targets.numel()
        hits = int((logits.argmax(-1) == targets).sum())
        delta = {"sum_log_probs": low_bridge_sum(logits, targets),
                 "ppl_count": n, "acc_correct": hits, "acc_count": n}
        ref_logits = mla_moe.forward(weights, ids[:, :-1], cfg).reshape(-1, vocab)
        steps.append(compare.step_readings(logits, delta, ref_logits, targets))
        total = [total[0] + delta["sum_log_probs"], total[1] + n]
        del logits, ref_logits
    readings = compare.worst(steps)
    bf16 = torch.bfloat16
    mean = torch.tensor(total[0], dtype=bf16) / torch.tensor(total[1], dtype=bf16)
    readings["ppl_value_rel"] = compare.perplexity_value_rel(float(torch.exp(mean)), *total)
    return readings


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, action="append", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = spec.cell(args.workload)
    device = torch.device(args.device)
    with torch.no_grad():
        for seed in args.seed:
            readings = mla_moe_control(cell, seed, device)
            limits = {k: cell.limits.get(k) for k in readings}
            failed = any(not (v <= limits[k]) for k, v in readings.items() if limits[k] is not None)
            print(json.dumps({"workload": args.workload, "seed": seed, "control_failed": failed,
                              "readings": readings, "limits": limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
