"""Run a cell's control: the reference put in the program's place, one
precision below the configuration's, judged by the run's own numbers.

    python3 evalbench/control.py --workload <cell> --seed <n> [--seed <n> ...]

For each seed, one JSON line: each number compared, its limit, and
``control_failed`` (true when at least one number is past its limit, as it
has to be). The benchmark's own runs never run this; it reads the upper
end of each limit (see PERF.md).

- CTR panel cells (float32 states): the panel in bfloat16, inputs and
  sums (``reference.ctr`` with ``dtype=torch.bfloat16``), over one pass at
  the cell's batch: a run's passes all see the same eval set.
- The LM cell (bfloat16): the forward with every product's operands in
  float8 e4m3 (``reference.gpt2.forward(..., fp8_control=True)``); the
  perplexity bridge with the program's op sequence (shift by the row's
  largest logit, exp, sum, log, subtract), each op's result rounded to
  float8 e4m3 where the program rounds to bfloat16, and each step's sum
  rounded to bfloat16 as the program rounds its own, over the cell's
  checked steps; the perplexity of their sums computed in bfloat16.
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

from evalbench import spec  # noqa: E402
from evalbench import traffic as gen  # noqa: E402
from evalbench.reference import compare, ctr, gpt2  # noqa: E402


def panel_control(cell, seed, device) -> dict:
    tr = cell.traffic
    scores, labels = gen.click_eval_set(cell.config, seed, device)
    got = ctr.panel_values(tr["panel"], scores, labels, tr["batch"], dtype=torch.bfloat16)
    want = ctr.panel_values(tr["panel"], scores, labels, tr["batch"])
    return compare.panel_readings([got], want)


def low_bridge_sum(logits: torch.Tensor, targets: torch.Tensor, rows: int = 1024) -> float:
    """One step's NLL sum as the control's bridge forms it (module
    docstring), from ``logits`` (N, V) and ``targets`` (N,), in blocks of
    ``rows`` rows, each block one tensor of the per-tensor scale."""
    q, logp = gpt2.fp8, []
    for a in range(0, logits.shape[0], rows):
        z = logits[a:a + rows].float()
        shifted = q(z - z.amax(-1, keepdim=True))
        lse = q(torch.log(q(q(torch.exp(shifted)).sum(-1, keepdim=True))))
        logp.append(q(shifted - lse).gather(1, targets[a:a + rows, None].long()).squeeze(1))
    return float(-torch.cat(logp).sum().to(torch.bfloat16))


def lm_control(cell, seed, device) -> dict:
    cfg, tr = cell.config, cell.traffic
    vocab = cfg["vocab_size"]
    weights = gen.lm_weights(cfg, seed, device)
    pool = gen.token_pool(cfg, tr, seed, device)
    steps, total = [], [0.0, 0]
    for k in gen.sample_steps(tr, seed):
        ids = pool[k % pool.shape[0]]
        targets = ids[:, 1:].reshape(-1)
        logits = gpt2.forward(weights, ids[:, :-1], cfg, fp8_control=True).reshape(-1, vocab)
        n = targets.numel()
        hits = int((logits.argmax(-1) == targets).sum())
        delta = {"sum_log_probs": low_bridge_sum(logits, targets),
                 "ppl_count": n, "acc_correct": hits, "acc_count": n}
        ref_logits = gpt2.forward(weights, ids[:, :-1], cfg).reshape(-1, vocab)
        steps.append(compare.step_readings(logits, delta, ref_logits, targets))
        total = [total[0] + delta["sum_log_probs"], total[1] + n]
        del logits, ref_logits
    readings = compare.worst(steps)
    mean = torch.tensor(total[0], dtype=torch.bfloat16) / torch.tensor(total[1], dtype=torch.bfloat16)
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
    run = lm_control if cell.config["loop"] == "lm_eval" else panel_control
    with torch.no_grad():
        for seed in args.seed:
            readings = run(cell, seed, device)
            limits = {k: cell.limits.get(k) for k in readings}
            failed = any(not (v <= limits[k]) for k, v in readings.items() if limits[k] is not None)
            print(json.dumps({"workload": args.workload, "seed": seed, "control_failed": failed,
                              "readings": readings, "limits": limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
