"""A rolling-window perplexity eval of a Kimi Linear LM (KDA + NoPE MLA +
MoE over a held share of the experts), as ``mla_moe_eval.py`` runs the
MLA + MoE LM.

Set-up builds ``torcheval_tpu_torch.models.KimiLinearLM`` at the
configuration's widths on ``meta`` and loads weights drawn on the device
from the seed (``evalbench.kimi_linear_weights``) with ``assign=True``, so
the weights are held once; then it draws ``pool_steps`` steps of ids and
runs ``warmup_steps`` steps. Each step of the window is one forward over
``windows_per_step`` windows of ``window`` tokens, then the metric updates
over its logits through ``toolkit.update_collection`` (``Perplexity`` on
(B, S, V), ``MulticlassAccuracy`` on (B x S, V)), and ends in
``torch.cuda.synchronize()``. The window closes at the first step that
ends past ``seconds``.

End to end: ``tokens_per_s`` and ``step_ms_p95``, as in ``lm_eval.py``,
with the same ranges and record keys. ``checked_steps`` steps drawn from
the seed keep their logits and the metric states' change; after the window
the model is freed and the reference (``reference/kimi_linear.py``)
recomputes those steps in float32 from its own routing, its logits made
in blocks of rows. Beside ``lm_eval.py``'s numbers: ``route_load_gap``, on
each checked step the pairs the program's grouped products computed for
each held expert of each MoE layer (``parallel.moe.moe_loads``, read
around that step outside its timing) against the pairs the reference's
own routing sent that expert, summed absolute differences over the
reference's held pairs (routing near-ties between bfloat16 and float32
move a few pairs, so it has a limit above 0); and ``route_count_gap``,
the routed pairs counted against tokens x ``num_experts_per_token`` x MoE
layers for every step run (exact, limit 0). ``counters`` carry the KDA
kernels' launches (two scans and a convolution a KDA layer a forward on
the card, none where they run as ops) and the ``moe`` source's change. A
traced run then profiles two more steps with the program's recorder on
and keeps the device time of each model span under
``record["model_spans"]`` (``evalbench/model_spans.py``), the held pairs
of those steps under ``record["model_span_held_pairs"]``, and
``record["step_flops"]`` the forward's analytic FLOPs
(``roofline_kimi_linear.forward_flops``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from evalbench import kimi_linear_weights, roofline_kimi_linear
from evalbench import traffic as gen
from evalbench.harness import Outcome, checks_from
from evalbench.model_spans import profile_steps
from evalbench.reference import compare, kimi_linear
from torcheval_tpu_torch.metrics import MulticlassAccuracy, Perplexity, toolkit
from torcheval_tpu_torch.models import KimiLinearConfig, KimiLinearLM
from torcheval_tpu_torch.ops import _kernels
from torcheval_tpu_torch.parallel.moe import moe_counts, moe_loads
from torcheval_tpu_torch.utils.compile_counter import CompileCounter

MODEL_SPAN_STEPS = 2


def _states(ppl, acc) -> torch.Tensor:
    return torch.stack([ppl.sum_log_probs.double(), ppl.num_total.double(),
                        acc.num_correct.double(), acc.num_total.double()])


def _held_loads(routers, start: int, held: int):
    """Each MoE layer's pairs computed so far for its held experts."""
    out = []
    for r in routers:
        loads = moe_loads(r)
        out.append(torch.zeros(held, dtype=torch.int64) if loads is None
                   else loads[start:start + held])
    return out


def _model(cfg, seed, device) -> KimiLinearLM:
    model = KimiLinearLM(KimiLinearConfig.from_dict(cfg), device="meta", dtype=torch.bfloat16)
    model.load_state_dict(kimi_linear_weights.weights(cfg, seed, device), assign=True)
    return model


def run(cell, *, seed, seconds, tracer, device, t0) -> Outcome:
    cfg, tr = cell.config, cell.traffic
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    vocab = cfg["vocab_size"]
    moe_layers = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    with torch.no_grad():
        model = _model(cfg, seed, device)
        routers = [layer.moe.router for layer in model.layers if not layer.dense]
        start, held = int(cfg.get("held_expert_start", 0)), int(cfg["num_experts"])
        pool = gen.token_pool(cfg, tr, seed, device)
        ppl = Perplexity(device=device)
        acc = MulticlassAccuracy(num_classes=vocab, device=device)

        def step(k):
            ids = pool[k % pool.shape[0]]
            inputs, targets = ids[:, :-1], ids[:, 1:]
            with tracer.range("evalbench.step"):
                with tracer.range("evalbench.forward"):
                    logits = model(inputs)
                with tracer.range("evalbench.metric_update"):
                    toolkit.update_collection({"perplexity": ppl}, logits, targets)
                    toolkit.update_collection({"accuracy": acc}, logits.reshape(-1, vocab),
                                              targets.reshape(-1))
            return logits

        for k in range(tr["warmup_steps"]):
            step(k)
        sync()
        ppl.reset()
        acc.reset()
        sync()
        setup_s = time.perf_counter() - t0

        checked = set(gen.sample_steps(tr, seed))
        kept = {}
        times = []
        trace_at, trace_n = tr["trace"]["start_step"], tr["trace"]["steps"]
        traced_from, traced_steps = None, 0
        launches_before = dict(_kernels.LAUNCHES)
        moe_before = moe_counts()
        done = 0
        with CompileCounter() as captures:
            t_start = time.perf_counter()
            while True:
                if tracer.wanted and done == trace_at:
                    tracer.start()
                    traced_from = done
                before = _states(ppl, acc) if done in checked else None
                if before is not None:
                    loads_before = _held_loads(routers, start, held)
                h0 = time.perf_counter()
                logits = step(done)
                sync()
                times.append(time.perf_counter() - h0)
                if before is not None:
                    loads = [a - b for a, b in zip(_held_loads(routers, start, held),
                                                   loads_before)]
                    kept[done] = (logits, before, _states(ppl, acc), loads)
                del logits
                done += 1
                if tracer.active and done == traced_from + trace_n:
                    tracer.stop()
                    if tracer.record is not None:
                        traced_steps = trace_n
                    trace_at = done + trace_n
                if time.perf_counter() - t_start >= seconds:
                    break
            if tracer.active:
                tracer.stop()
                if tracer.record is not None:
                    traced_steps = done - traced_from
            sync()
            window_s = time.perf_counter() - t_start
        memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        moe_after = moe_counts()
        counters = {"k1_launches": _kernels.LAUNCHES["fused_auc_hist"]
                    - launches_before["fused_auc_hist"],
                    "kda_launches": _kernels.LAUNCHES["kda"] - launches_before["kda"],
                    "kda_conv_launches": _kernels.LAUNCHES["kda_conv"] - launches_before["kda_conv"],
                    "graph_captures": captures.programs}
        for key in ("forwards", "routed_pairs", "held_pairs", "loaded_pairs"):
            counters["moe_" + key] = moe_after[key] - moe_before[key]
        final = _states(ppl, acc).tolist()
        value = float(ppl.compute())
        # the held pairs of the profiled steps (a trace taken again runs
        # the same steps again: its pairs are counted once)
        calls, span_held = [], moe_counts()["held_pairs"]
        model_spans = (profile_steps(lambda k: calls.append(k) or step(k), done,
                                     MODEL_SPAN_STEPS, device) if tracer.enabled else None)
        span_held = ((moe_counts()["held_pairs"] - span_held) * MODEL_SPAN_STEPS
                     / max(len(calls), 1))
        del model, routers, pool, ppl, acc
        if cuda:
            torch.cuda.empty_cache()

        weights = kimi_linear_weights.weights(cfg, seed, device)
        pool = gen.token_pool(cfg, tr, seed, device)
        steps, load_gaps = [], []
        for k in sorted(checked):
            if k not in kept:
                continue
            logits, before, after, loads = kept.pop(k)
            d = (after - before).tolist()
            ids = pool[k % pool.shape[0]]
            ref_loads = []
            ref_hidden = kimi_linear.hidden(weights, ids[:, :-1], cfg, loads=ref_loads)
            load_gaps.append(kimi_linear.route_load_gap(loads, ref_loads))
            steps.append(kimi_linear.step_readings(
                logits.reshape(-1, vocab), dict(zip(("sum_log_probs", "ppl_count", "acc_correct",
                                                     "acc_count"), d)),
                ref_hidden.reshape(-1, ref_hidden.shape[-1]), weights, ids[:, 1:].reshape(-1)))
            del logits, ref_hidden
        readings = compare.worst(steps if len(steps) == len(checked) else [])
        readings["route_load_gap"] = (max(load_gaps) if len(load_gaps) == len(checked)
                                      else float("nan"))
        tokens = int(pool.shape[1] * (pool.shape[2] - 1))
        readings["count_gap"] += abs(final[1] - done * tokens) + abs(final[3] - done * tokens)
        readings["ppl_value_rel"] = compare.perplexity_value_rel(value, final[0], final[1])
        routed = done * tokens * cfg["num_experts_per_token"] * moe_layers
        readings["route_count_gap"] = float(abs(counters["moe_routed_pairs"] - routed))

    window = tr["window"]
    record = {"step_s": times, "tokens_per_step": tokens, "config": cfg,
              "windows_per_step": tr["windows_per_step"], "window": window,
              "traced_steps": traced_steps, "model_spans": model_spans,
              "model_span_held_pairs": span_held if model_spans else None,
              "step_flops": roofline_kimi_linear.forward_flops(
                  cfg, window, batch=tr["windows_per_step"])}
    return Outcome(
        metrics={"tokens_per_s": done * tokens / window_s,
                 "step_ms_p95": float(np.percentile(times, 95)) * 1e3,
                 "setup_s": setup_s},
        attempted=done, failed=0, checks=checks_from(readings, cell.limits),
        memory_peak_bytes=memory_peak, record=record, counters=counters)
