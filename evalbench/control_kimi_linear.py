"""Run a Kimi Linear cell's control: the reference put in the program's
place, one precision below the configuration's, judged by the run's own
numbers (``control_mla_moe.py`` does the same for the MLA + MoE cell).

    python3 evalbench/control_kimi_linear.py --workload kimilinear48b_eval_32k --seed <n> [--seed <n> ...]
    python3 evalbench/control_kimi_linear.py --workload kimilinear48b_eval_32k --seed <n> --bf16-state

For each seed, one JSON line: each number compared, its limit, and
``control_failed`` (true when at least one number is past its limit, as it
has to be for the control). The control is the reference's forward with
every product's operands in float8 e4m3, the router's included, and the
KDA scan's q, k and v in float8, its decays, beta and state in float32
(``reference.kimi_linear.hidden(..., fp8_control=True)``), float8 logits,
and the perplexity bridge of ``control.py`` (``low_bridge_sum``), over the
cell's checked steps; the perplexity of their sums computed in bfloat16;
and ``route_load_gap``, its routing's per-expert loads against the
reference's.

``--bf16-state`` reads instead the program itself with its KDA scan
replaced by ``kda_ops_bf16_state``, the op sequence holding the state in
bfloat16 between chunks (everything else as the timed path runs it, the
bridge included), against the same limits: what a scan that keeps a
bfloat16 state would read. It has no expert counts, so neither
``route_count_gap`` nor ``route_load_gap`` is among its numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from evalbench import kimi_linear_weights, spec  # noqa: E402
from evalbench import traffic as gen  # noqa: E402
from evalbench.control import low_bridge_sum  # noqa: E402
from evalbench.reference import compare, kimi_linear  # noqa: E402


def kda_ops_bf16_state(q, k, v, g, beta, scale, chunk=64):
    """``ops.kda.kda_ops`` with its state rounded to bfloat16 after each
    chunk (the state pass a narrower kernel would make)."""
    from torcheval_tpu_torch.ops.kda import SUB, _intra

    b, t, h, dk = q.shape
    n = -(-t // chunk)

    def blocks(x):  # (B, T, H, D) -> (B, H, n, C, D), float32, zero-padded
        x = F.pad(x.float(), (0, 0, 0, 0, 0, n * chunk - t))
        return x.reshape(b, n, chunk, h, -1).permute(0, 3, 1, 2, 4)

    qc, kc, vc, gc, bc = blocks(q) * scale, blocks(k), blocks(v), blocks(g), blocks(beta[..., None])
    eye = torch.eye(chunk, device=q.device)
    S = q.new_zeros((b, h, dk, v.shape[-1]), dtype=torch.float32)
    out = []
    for i in range(n):
        qi, ki, vi, bi = qc[:, :, i], kc[:, :, i], vc[:, :, i], bc[:, :, i]
        G = gc[:, :, i].cumsum(-2)
        A, M = _intra(qi, ki, G, min(SUB, chunk))
        rhs = torch.cat([ki * torch.exp(G), vi], -1) * bi
        W = torch.linalg.solve_triangular(eye + A * bi, rhs, upper=False, unitriangular=True)
        Wk, Wv = W.split([dk, v.shape[-1]], -1)
        U = Wv - Wk @ S
        out.append((qi * torch.exp(G)) @ S + M @ U)
        S = (torch.exp(G[..., -1, :])[..., None] * S
             + (ki * torch.exp(G[..., -1:, :] - G)).transpose(-1, -2) @ U)
        S = S.to(torch.bfloat16).float()
    o = torch.stack(out, 2)  # (B, H, n, C, d_v)
    return o.permute(0, 2, 3, 1, 4).reshape(b, n * chunk, h, -1)[:, :t].to(v.dtype)


def kimi_linear_control(cell, seed, device) -> dict:
    """The float8 control's readings for ``seed``."""
    cfg, tr = cell.config, cell.traffic
    vocab = cfg["vocab_size"]
    weights = kimi_linear_weights.weights(cfg, seed, device)
    pool = gen.token_pool(cfg, tr, seed, device)
    steps, gaps, total = [], [], [0.0, 0]
    for k in gen.sample_steps(tr, seed):
        ids = pool[k % pool.shape[0]]
        targets = ids[:, 1:].reshape(-1)
        loads, ref_loads = [], []
        low = kimi_linear.hidden(weights, ids[:, :-1], cfg, fp8_control=True, loads=loads)
        logits = kimi_linear.head_rows(low.reshape(-1, low.shape[-1]), weights, True)
        del low
        n = targets.numel()
        hits = compare._argmax_hits(logits, targets)
        delta = {"sum_log_probs": low_bridge_sum(logits, targets),
                 "ppl_count": n, "acc_correct": hits, "acc_count": n}
        ref = kimi_linear.hidden(weights, ids[:, :-1], cfg, loads=ref_loads)
        steps.append(kimi_linear.step_readings(logits, delta, ref.reshape(-1, ref.shape[-1]),
                                               weights, targets))
        gaps.append(kimi_linear.route_load_gap(loads, ref_loads))
        total = [total[0] + delta["sum_log_probs"], total[1] + n]
        del logits, ref
    readings = compare.worst(steps)
    readings["route_load_gap"] = max(gaps)
    bf16 = torch.bfloat16
    mean = torch.tensor(total[0], dtype=bf16) / torch.tensor(total[1], dtype=bf16)
    readings["ppl_value_rel"] = compare.perplexity_value_rel(float(torch.exp(mean)), *total)
    return readings


def bf16_state_readings(cell, seed, device) -> dict:
    """The program with a bfloat16-state scan: its readings for ``seed``."""
    from torcheval_tpu_torch.metrics import MulticlassAccuracy, Perplexity, toolkit
    from torcheval_tpu_torch.models import KimiLinearConfig, KimiLinearLM
    from torcheval_tpu_torch.models import kimi_linear as model_module

    cfg, tr = cell.config, cell.traffic
    vocab = cfg["vocab_size"]
    model = KimiLinearLM(KimiLinearConfig.from_dict(cfg), device="meta", dtype=torch.bfloat16)
    model.load_state_dict(kimi_linear_weights.weights(cfg, seed, device), assign=True)
    pool = gen.token_pool(cfg, tr, seed, device)
    real = model_module.kda_chunked
    model_module.kda_chunked = kda_ops_bf16_state
    kept = []
    try:
        for k in gen.sample_steps(tr, seed):
            ids = pool[k % pool.shape[0]]
            ppl = Perplexity(device=device)
            acc = MulticlassAccuracy(num_classes=vocab, device=device)
            logits = model(ids[:, :-1])
            toolkit.update_collection({"perplexity": ppl}, logits, ids[:, 1:])
            toolkit.update_collection({"accuracy": acc}, logits.reshape(-1, vocab),
                                      ids[:, 1:].reshape(-1))
            delta = {"sum_log_probs": float(ppl.sum_log_probs), "ppl_count": float(ppl.num_total),
                     "acc_correct": float(acc.num_correct), "acc_count": float(acc.num_total)}
            kept.append((k, logits.reshape(-1, vocab), delta))
    finally:
        model_module.kda_chunked = real
    del model
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    weights = kimi_linear_weights.weights(cfg, seed, device)
    steps, total = [], [0.0, 0]
    for k, logits, delta in kept:
        ids = pool[k % pool.shape[0]]
        ref = kimi_linear.hidden(weights, ids[:, :-1], cfg)
        steps.append(kimi_linear.step_readings(logits, delta, ref.reshape(-1, ref.shape[-1]),
                                               weights, ids[:, 1:].reshape(-1)))
        total = [total[0] + delta["sum_log_probs"], total[1] + int(delta["ppl_count"])]
    readings = compare.worst(steps)
    readings["ppl_value_rel"] = compare.perplexity_value_rel(
        float(torch.exp(torch.tensor(total[0] / total[1]))), *total)
    return readings


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, action="append", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--bf16-state", action="store_true",
                   help="read the program with a bfloat16-state scan instead of the control")
    args = p.parse_args(argv)
    cell = spec.cell(args.workload)
    device = torch.device(args.device)
    read = bf16_state_readings if args.bf16_state else kimi_linear_control
    with torch.no_grad():
        for seed in args.seed:
            t0 = time.perf_counter()
            readings = read(cell, seed, device)
            if device.type == "cuda":
                torch.cuda.empty_cache()
            limits = {k: cell.limits.get(k) for k in readings}
            failed = any(not (v <= limits[k]) for k, v in readings.items() if limits[k] is not None)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "bf16_state": args.bf16_state,
                              "control_failed": failed, "readings": readings,
                              "limits": limits, "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
