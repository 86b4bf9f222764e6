"""The MLA + MoE model's program spans in ``torch.profiler`` traces and
its ``moe`` counter source, in the style of ``test_torch_port_spans.py``.

- With the recorder on and a profiler collecting, a forward opens one
  ``torcheval.mla`` range a layer and, in each MoE layer,
  ``torcheval.moe.route``, ``torcheval.moe.experts`` and
  ``torcheval.moe.shared``, in that order; each range is one span frame.
- With the recorder off none opens and no frame is pushed.
- ``obs.default_registry()``'s ``moe`` source counts each forward, and
  tokens x k a MoE layer as routed pairs, exactly.

This file imports no JAX.
"""

from __future__ import annotations

import json
import os
import tempfile

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from evalbench import mla_moe_weights
from torcheval_tpu_torch import obs
from torcheval_tpu_torch.models import MLAMoEConfig, MLAMoELM
from torcheval_tpu_torch.obs import trace as obs_trace

SIZES = dict(vocab_size=64, hidden_size=32, num_hidden_layers=3, num_attention_heads=2,
             kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8,
             intermediate_size=48, moe_intermediate_size=12, n_routed_experts=8,
             n_shared_experts=1, num_experts_per_tok=2, first_k_dense_replace=1,
             max_position_embeddings=32)
CONFIG = MLAMoEConfig(**SIZES)
MODEL_SPANS = ("torcheval.mla", "torcheval.moe.route", "torcheval.moe.experts",
               "torcheval.moe.shared")


@pytest.fixture
def recording():
    obs.enable()
    obs.recorder().reset()
    try:
        yield obs.recorder()
    finally:
        obs.disable()
        obs.recorder().reset()


@pytest.fixture
def model():
    m = MLAMoELM(CONFIG, device="meta", dtype=torch.float32)
    weights = mla_moe_weights.weights(dict(SIZES, init_std=0.1, e_score_correction_bias_std=0.1),
                                      2, "cpu", dtype=torch.float32)
    m.load_state_dict(weights, assign=True)
    return m


def _tokens(batch=2, seq=12):
    g = torch.Generator().manual_seed(4)
    return torch.randint(0, CONFIG.vocab_size, (batch, seq), generator=g)


def _ranges(prof):
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return sorted((e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e["name"].startswith("torcheval.")), key=lambda e: float(e["ts"]))


def test_recorder_on_opens_the_model_spans(recording, model, monkeypatch):
    frames = []
    push = obs_trace.push

    def keep(name):
        frame = push(name)
        frames.append(frame.name)
        return frame

    monkeypatch.setattr(obs_trace, "push", keep)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        model(_tokens())
    names = [r["name"] for r in _ranges(prof)]
    moe_layers = CONFIG.num_hidden_layers - CONFIG.first_k_dense_replace
    assert names.count("torcheval.mla") == CONFIG.num_hidden_layers
    for name in MODEL_SPANS[1:]:
        assert names.count(name) == moe_layers, name
    moe_order = [n for n in names if n.startswith("torcheval.moe.")]
    assert moe_order == list(MODEL_SPANS[1:]) * moe_layers
    assert sorted(names) == sorted(frames)
    assert recording.log.total == 0  # the spans record no event


def test_recorder_on_without_a_profiler_leaves_no_frame_open(recording, model):
    with torch.no_grad():
        model(_tokens())
    assert obs_trace.current() is None


def test_recorder_off_opens_no_span(model, monkeypatch):
    assert not obs.enabled()

    def no_push(name):
        raise AssertionError(f"span {name!r} pushed with the recorder off")

    monkeypatch.setattr(obs_trace, "push", no_push)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        model(_tokens())
    assert _ranges(prof) == []


def test_moe_source_counts_forwards_and_routed_pairs_exactly(model):
    registry = obs.default_registry()
    assert "moe" in registry.sources
    before = registry.read()["moe"]
    assert set(before) == {"forwards", "routed_pairs", "loaded_pairs", "load_max_over_mean"}
    tokens = _tokens(batch=3, seq=10)
    with torch.no_grad():
        model(tokens)
        model(tokens[:1])
    after = registry.read()["moe"]
    moe_layers = CONFIG.num_hidden_layers - CONFIG.first_k_dense_replace
    pairs = (30 + 10) * CONFIG.num_experts_per_tok * moe_layers
    assert after["forwards"] - before["forwards"] == 2
    assert after["routed_pairs"] - before["routed_pairs"] == pairs
    assert after["loaded_pairs"] - before["loaded_pairs"] == pairs
    assert registry.flat()["moe.forwards"] == after["forwards"]
