"""The four remaining example scripts of the port on the CPU
(``torcheval_tpu_torch/examples/``): each runs with ``--device cpu`` and
prints the marker its JAX twin prints (``tests/test_examples.py``); the
multi-process one runs under ``torcheval_tpu_torch.launcher`` over gloo
with two workers."""

from __future__ import annotations

import math
import os

import pytest
import torch

from torcheval_tpu_torch import launcher
from torcheval_tpu_torch.examples import (
    eval_panel_example,
    llm_eval_example,
    multihost_example,
    scaleout_example,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_eval_panel_example(capsys):
    out = eval_panel_example.main(["--device", "cpu"])
    printed = capsys.readouterr().out
    assert "eval panel done" in printed and "checkpoint round-trip ok" in printed
    assert out["accuracy_restored"] == out["accuracy"]
    # the confusion matrix's trace over its sum is the accuracy
    assert abs(out["trace_fraction"] - out["accuracy"]) < 1e-6
    assert 0.0 <= out["confidence_auroc"] <= 1.0


def test_llm_eval_example(capsys):
    out = llm_eval_example.main(["--device", "cpu"])
    printed = capsys.readouterr().out
    assert "perplexity=" in printed and "long-context perplexity=" in printed
    # a random model over 127 live tokens: near-uniform perplexity
    assert 50 < out["perplexity"] < 500 and 50 < out["long_context_perplexity"] < 500
    assert all(math.isfinite(v) for v in out.values())


def test_scaleout_example(capsys):
    out = scaleout_example.main(["--device", "cpu", "--world", "4"])
    printed = capsys.readouterr().out
    assert "scaleout done" in printed and "dpxsp composed ring attention ok" in printed
    assert 0.0 <= out["pp_accuracy"] <= 1.0 and out["sp_perplexity"] > 1.0
    assert 0.0 < out["dpsp_pos_frac"] < 1.0


def test_multihost_example_alone(capsys):
    out = multihost_example.main(["--device", "cpu"])
    assert "done" in capsys.readouterr().out
    assert out["world_size"] == 1 and 0.0 <= out["synced"]["auroc"] <= 1.0


def test_multihost_example_under_the_launcher_over_gloo():
    script = os.path.join(REPO, "torcheval_tpu_torch", "examples", "multihost_example.py")
    outs = launcher.launch(script, ["--device", "cpu"], nproc=2, platform="cpu", timeout=240)
    assert "done" in outs[0] and "pooled over 2 processes" in outs[0]
    assert "done" not in outs[1]  # only rank 0 prints


@pytest.mark.parametrize("module", [eval_panel_example, llm_eval_example, multihost_example,
                                    scaleout_example])
def test_examples_default_to_the_card(module):
    """``--device`` defaults to ``cuda``: with a card the example runs
    there; without one it raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        module.main([])
        return
    with pytest.raises((RuntimeError, AssertionError)):
        module.main([])
