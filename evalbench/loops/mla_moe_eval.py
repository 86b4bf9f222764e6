"""A rolling-window perplexity eval of an MLA + MoE LM (DeepSeek-V3's
architecture), as ``lm_eval.py`` runs ``TransformerLM``.

Set-up builds ``torcheval_tpu_torch.models.MLAMoELM`` at the
configuration's widths on ``meta`` and loads weights drawn on the device
from the seed (``evalbench.mla_moe_weights``) with ``assign=True``, so the
weights are held once; then it draws ``pool_steps`` steps of ids and runs
``warmup_steps`` steps. Each step of the window is one forward over
``windows_per_step`` windows of ``window`` tokens, then the metric updates
over its logits through ``toolkit.update_collection`` (``Perplexity`` on
(B, S, V), ``MulticlassAccuracy`` on (B x S, V)), and ends in
``torch.cuda.synchronize()``. The window closes at the first step that
ends past ``seconds``.

End to end: ``tokens_per_s`` and ``step_ms_p95``, as in ``lm_eval.py``,
with the same ranges and record keys. ``checked_steps`` steps drawn from
the seed keep their logits and the metric states' change; after the window
the model is freed and the reference (``reference/mla_moe.py``) recomputes
those steps in float32 from its own routing. Beside ``lm_eval.py``'s
numbers, ``route_count_gap``: the pairs the program's per-expert loads
(the ``moe`` counter source) gained over the window against tokens x
``num_experts_per_tok`` x MoE layers for every step run (exact, limit 0:
the layer drops nothing). A traced run then profiles two more steps with
the program's recorder on and keeps the device time of each model span
under ``record["model_spans"]`` (``evalbench/model_spans.py``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from evalbench import mla_moe_weights
from evalbench import traffic as gen
from evalbench.harness import Outcome, checks_from
from evalbench.model_spans import profile_steps
from evalbench.reference import compare, mla_moe
from torcheval_tpu_torch.metrics import MulticlassAccuracy, Perplexity, toolkit
from torcheval_tpu_torch.models import MLAMoEConfig, MLAMoELM
from torcheval_tpu_torch.ops import _kernels
from torcheval_tpu_torch.parallel.moe import moe_counts
from torcheval_tpu_torch.utils.compile_counter import CompileCounter

MODEL_SPAN_STEPS = 2


def _states(ppl, acc) -> torch.Tensor:
    return torch.stack([ppl.sum_log_probs.double(), ppl.num_total.double(),
                        acc.num_correct.double(), acc.num_total.double()])


def _model(cfg, seed, device) -> MLAMoELM:
    model = MLAMoELM(MLAMoEConfig.from_dict(cfg), device="meta", dtype=torch.bfloat16)
    model.load_state_dict(mla_moe_weights.weights(cfg, seed, device), assign=True)
    return model


def run(cell, *, seed, seconds, tracer, device, t0) -> Outcome:
    cfg, tr = cell.config, cell.traffic
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    vocab = cfg["vocab_size"]
    moe_layers = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    with torch.no_grad():
        model = _model(cfg, seed, device)
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
        k1_before = _kernels.LAUNCHES["fused_auc_hist"]
        moe_before = moe_counts()
        done = 0
        with CompileCounter() as captures:
            t_start = time.perf_counter()
            while True:
                if tracer.wanted and done == trace_at:
                    tracer.start()
                    traced_from = done
                before = _states(ppl, acc) if done in checked else None
                h0 = time.perf_counter()
                logits = step(done)
                sync()
                times.append(time.perf_counter() - h0)
                if before is not None:
                    kept[done] = (logits, before, _states(ppl, acc))
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
        counters = {"k1_launches": _kernels.LAUNCHES["fused_auc_hist"] - k1_before,
                    "graph_captures": captures.programs,
                    "moe_forwards": moe_after["forwards"] - moe_before["forwards"],
                    "moe_routed_pairs": moe_after["routed_pairs"] - moe_before["routed_pairs"],
                    "moe_loaded_pairs": moe_after["loaded_pairs"] - moe_before["loaded_pairs"],
                    "moe_load_max_over_mean": moe_after["load_max_over_mean"]}
        final = _states(ppl, acc).tolist()
        value = float(ppl.compute())
        model_spans = (profile_steps(step, done, MODEL_SPAN_STEPS, device)
                       if tracer.enabled else None)
        del model, pool, ppl, acc
        if cuda:
            torch.cuda.empty_cache()

        weights = mla_moe_weights.weights(cfg, seed, device)
        pool = gen.token_pool(cfg, tr, seed, device)
        steps = []
        for k in sorted(checked):
            if k not in kept:
                continue
            logits, before, after = kept.pop(k)
            d = (after - before).tolist()
            ids = pool[k % pool.shape[0]]
            ref_logits = mla_moe.forward(weights, ids[:, :-1], cfg)
            steps.append(compare.step_readings(
                logits.reshape(-1, vocab), dict(zip(("sum_log_probs", "ppl_count", "acc_correct",
                                                     "acc_count"), d)),
                ref_logits.reshape(-1, vocab), ids[:, 1:].reshape(-1)))
            del logits, ref_logits
        readings = compare.worst(steps if len(steps) == len(checked) else [])
        tokens = int(pool.shape[1] * (pool.shape[2] - 1))
        readings["count_gap"] += abs(final[1] - done * tokens) + abs(final[3] - done * tokens)
        readings["ppl_value_rel"] = compare.perplexity_value_rel(value, final[0], final[1])
        routed = done * tokens * cfg["num_experts_per_tok"] * moe_layers
        readings["route_count_gap"] = float(abs(counters["moe_loaded_pairs"] - routed)
                                            + abs(counters["moe_routed_pairs"] - routed))

    record = {"step_s": times, "tokens_per_step": tokens, "config": cfg,
              "windows_per_step": tr["windows_per_step"], "window": tr["window"],
              "traced_steps": traced_steps, "model_spans": model_spans}
    return Outcome(
        metrics={"tokens_per_s": done * tokens / window_s,
                 "step_ms_p95": float(np.percentile(times, 95)) * 1e3,
                 "setup_s": setup_s},
        attempted=done, failed=0, checks=checks_from(readings, cell.limits),
        memory_peak_bytes=memory_peak, record=record, counters=counters)
