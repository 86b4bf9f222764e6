"""Whole runs on the CPU at tiny sizes: the cells are correct as they
stand, and each fault a cell can have turns ``correct`` false.

The faults are planted in the program underneath a run, as a later change
could plant them: an update that returns its state unchanged; half of each
batch left out (the mean taken over the rest); an answer altered where it
is produced. No cell spans chips, so no exchange can be left out.
"""

from __future__ import annotations

import pytest
import torch

from torcheval_tpu_torch.metrics import toolkit
from torcheval_tpu_torch.models import TransformerLM

CELLS = ("criteo_stream_pass", "criteo_exact_pass", "gpt2xl_eval")


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, tiny_cell, run_tiny):
    result = run_tiny(tiny_cell(name))
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {m["name"] for m in tiny_cell(name).end_to_end}


def _unchanged(monkeypatch):
    monkeypatch.setattr(toolkit, "update_collection", lambda metrics, *a, **k: metrics)


def _half_batch(monkeypatch):
    real = toolkit.update_collection

    def half(metrics, *args, **kwargs):
        return real(metrics, *(a[: a.shape[0] // 2] for a in args), **kwargs)

    monkeypatch.setattr(toolkit, "update_collection", half)


def _altered(monkeypatch):
    """The panel's first value a pass, or one token's logits, altered."""
    from torcheval_tpu_torch.metrics import BinaryAUROC, BinaryNormalizedEntropy

    for cls in (BinaryNormalizedEntropy, BinaryAUROC):
        real = cls.compute
        monkeypatch.setattr(cls, "compute", lambda self, real=real: real(self) * 1.01)
    real_forward = TransformerLM.forward

    def forward(self, tokens):
        out = real_forward(self, tokens).clone()
        out[0, 0, 0] += 50.0
        return out

    monkeypatch.setattr(TransformerLM, "forward", forward)


@pytest.mark.parametrize("fault", (_unchanged, _half_batch, _altered),
                         ids=("unchanged_state", "half_batch", "altered_answer"))
@pytest.mark.parametrize("name", CELLS)
def test_fault_turns_correct_false(name, fault, tiny_cell, run_tiny, monkeypatch):
    fault(monkeypatch)
    try:
        result = run_tiny(tiny_cell(name))
    except RuntimeError as e:  # the program refuses to compute: the run fails
        assert "no data" in str(e)
        return
    assert not result["correct"], result["checks"]


def test_biased_perplexity_bridge_turns_correct_false(tiny_cell, run_tiny, monkeypatch):
    """A bridge that takes 0.1 nats off every token's NLL, which no logit
    number sees, fails the step's NLL sum."""
    import importlib

    fp = importlib.import_module("torcheval_tpu_torch.metrics.functional.text.perplexity")
    real = fp._token_log_probs
    monkeypatch.setattr(fp, "_token_log_probs", lambda *a: real(*a) + 0.1)
    result = run_tiny(tiny_cell("gpt2xl_eval"))
    assert not result["correct"]
    failed = {k for k, v in result["checks"].items() if not v["value"] <= v["limit"]}
    assert failed == {"nll_sum_gap"}, result["checks"]


@pytest.mark.card
def test_stream_cell_on_card_launches_k1(tiny_cell):
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: K1 is a CUDA kernel with no CPU form")
    import time

    from evalbench import harness

    result = harness.run_cell(tiny_cell("criteo_stream_pass"), 5, 1.0, False,
                              torch.device("cuda", 0), time.perf_counter())
    assert result["correct"], result["checks"]
    assert result["counters"]["k1_launches"] == result["counters"]["streaming_updates"] > 0
