"""The port's eval-loop slice as a whole: ``chip_smoke.py``'s phases at
small sizes on the CPU, its refusal to run without a card, and one eval
loop (counters, loss mean, streaming AUC, local-replica sync) through the
port and through the JAX package on the same numpy stream."""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import torcheval_tpu.metrics as JM
from torcheval_tpu import distributed as jdist
from torcheval_tpu.metrics import toolkit as jtoolkit
import torcheval_tpu_torch.metrics as TM
from torcheval_tpu_torch import distributed as tdist
from torcheval_tpu_torch.metrics import toolkit as ttoolkit
from torcheval_tpu_torch.ops import _kernels

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"


def test_phase_classify_small_on_cpu():
    out = chip_smoke.phase_classify(CPU, n=2500, num_classes=100, batch=512)
    assert out["samples"] == 2500 and out["max_err_vs_float64"] <= 1e-5
    assert 0.0 < out["values"]["acc"] < 1.0


def test_phase_ctr_auc_small_on_cpu():
    _kernels.reset_launch_counts()
    out = chip_smoke.phase_ctr_auc(CPU, n=150_000, batch=40_000, mt_samples=1 << 14, num_tasks=4)
    assert out["updates"] == 2 * 4 + 1
    assert out["k1_launches"] == 0  # CPU tensors take the plain version
    assert out["max_err_vs_float64"] <= 1e-5


def test_phase_sync_small_on_cpu():
    out = chip_smoke.phase_sync(CPU, classify_n=2048, num_classes=50, batch=256,
                                ctr_n=1 << 16, ctr_batch=1 << 13)
    assert out["world"] == 4 and out["loss_abs_err"] <= 1e-6


def test_phase_curve_small_on_cpu():
    _kernels.reset_launch_counts()
    out = chip_smoke.phase_curve(CPU, n=150_000, batch=40_000, cls_n=2500, num_classes=40,
                                 cls_batch=512)
    assert out["k1_launches"] == 0  # CPU tensors take the plain histogram
    criteo, imagenet = out["criteo"], out["imagenet"]
    assert criteo["capacity"] == 1 << 18 and criteo["buffer_bytes"] == 8 * 4 * (1 << 18)
    assert max(criteo["err_vs_float64"].values()) <= chip_smoke.CURVE_TOL
    assert imagenet["classes_scored"] == 40
    assert max(imagenet["max_class_err_vs_float64"].values()) <= chip_smoke.CURVE_TOL


def test_exact_oracle_matches_the_jax_curve_metrics():
    """The smoke's float64 oracle (mid-rank Mann-Whitney, step-wise
    average precision) against the JAX package on tied scores."""
    rng = np.random.default_rng(9)
    s = (np.round(rng.random((3, 500)) * 30) / 30).astype(np.float32)
    y = (rng.random((3, 500)) < s).astype(np.float32)
    auroc, ap = chip_smoke._exact_oracle(torch.from_numpy(s), torch.from_numpy(y))
    np.testing.assert_allclose(auroc.numpy(), np.asarray(JM.BinaryAUROC(num_tasks=3).update(s, y).compute()),
                               atol=1e-6)
    np.testing.assert_allclose(ap.numpy(), np.asarray(JM.BinaryAUPRC(num_tasks=3).update(s, y).compute()),
                               atol=1e-6)


def test_phase_mp_sync_small_on_cpu():
    out = chip_smoke.phase_mp_sync(CPU, classify_n=1024, num_classes=20, batch=256,
                                   ctr_n=1 << 14, ctr_batch=1 << 12, timeout=180)
    assert out["world"] == 2 and out["loss_abs_err"] <= 1e-6
    assert "exact_auroc" in out["bitwise"] and len(out["sync_seconds"]) == 2


def test_main_refuses_to_run_without_cuda(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert chip_smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_smoke_alone_in_a_directory_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _eval_stream(seed, steps=8, c=20):
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        logits = rng.standard_normal((128, c)).astype(np.float32)
        labels = rng.integers(0, c, 128)
        logits[np.arange(128), labels] += 1.5
        loss = np.float32(rng.random())
        scores = rng.random(1000).astype(np.float32)
        clicks = (rng.random(1000) < scores).astype(np.float32)
        yield logits, labels, loss, scores, clicks


def _run_loop(P, tk, group, **kw):
    c = 20
    replicas = [
        {
            "acc": P.MulticlassAccuracy(**kw),
            "f1": P.MulticlassF1Score(num_classes=c, average="macro", **kw),
            "loss": P.Mean(**kw),
            "auroc": P.StreamingBinaryAUROC(num_bins=2048, **kw),
            "auprc": P.StreamingBinaryAUPRC(num_bins=2048, **kw),
        }
        for _ in range(2)
    ]
    for i, (logits, labels, loss, scores, clicks) in enumerate(_eval_stream(5)):
        coll = replicas[i % 2]
        tk.update_collection({k: coll[k] for k in ("acc", "f1")}, logits, labels)
        coll["loss"].update(loss)
        tk.update_collection({k: coll[k] for k in ("auroc", "auprc")}, scores, clicks)
    local = {name: m.compute() for name, m in replicas[0].items()}
    return local, tk.sync_and_compute_collection(replicas, group)


def test_eval_loop_slice_matches_jax():
    t_local, t_synced = _run_loop(TM, ttoolkit, tdist.LocalReplicaGroup([torch.device(CPU)] * 2), device=CPU)
    j_local, j_synced = _run_loop(JM, jtoolkit, jdist.LocalReplicaGroup(jax.devices("cpu")[:2]))
    for ours, theirs in ((t_local, j_local), (t_synced, j_synced)):
        for name in ours:
            np.testing.assert_allclose(
                np.asarray(ours[name]), np.asarray(theirs[name]), atol=1e-6, err_msg=name
            )


def test_phase_recsys_small_on_cpu():
    _kernels.reset_launch_counts()
    out = chip_smoke.phase_recsys(
        CPU, ctr_n=150_000, ctr_batch=40_000, mt_samples=1 << 14, rows_n=1 << 15,
        row_tasks=50, ncf_users=3000, ncf_candidates=100, ncf_batch=1024, marco_queries=300,
        marco_candidates=100, marco_batch=64, id_n=4096, id_features=3)
    assert out["k1_launches"] == 0  # CPU tensors take the plain histogram
    criteo = out["criteo"]
    assert criteo["panel_updates"] == 4
    assert max(criteo["value_rel_err_vs_float64"].values()) <= 1e-5
    assert criteo["rows"]["dropped_ids"] > 0
    assert out["ncf"]["bitwise"] and out["msmarco"]["bitwise"] and out["dlrm_ids"]["bitwise"]
    assert out["msmarco"]["ignored_rows"] == 10 * out["msmarco"]["updates"]
    assert 0.9 < out["msmarco"]["relevant_per_query"] < 1.2


def test_phase_lm_eval_small_on_cpu():
    _kernels.reset_launch_counts()
    out = chip_smoke.phase_lm_eval(
        CPU, vocab=1000, context=64, tokens=340, stride=8, sliding_windows=3, bf16_windows=2,
        margin=5.0, chunk=16, pairs=150, utterances=130, text_vocab=2000)
    assert out["k1_launches"] == 0
    ppl = out["perplexity"]
    assert ppl["nonoverlapping"]["windows"] == 6 and ppl["nonoverlapping"]["targets"] == 340
    assert ppl["sliding"]["targets"] == 3 * 8 and ppl["bf16"]["dtype"] == "bfloat16"
    for name in ("nonoverlapping", "sliding", "bf16"):
        assert ppl[name]["nll_rel_err_vs_float64"] <= ppl[name]["nll_rel_bound"]
        assert 3.0 <= ppl[name]["perplexity"] <= 30.0
    assert ppl["nonoverlapping"]["nll_rel_err_vs_float64"] <= 1e-6
    assert out["bleu"]["counters_bitwise"] and out["bleu"]["abs_err_vs_float64"] <= 1e-6
    assert out["word_rates"]["bitwise"] and out["word_rates"]["errors"] > 0


def test_lm_oracle_reads_out_of_range_targets_as_jax_does():
    """The smoke's float64 perplexity oracle against the JAX package, with
    targets -1, V and V + 7 planted and ``-100`` ignored."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 12, 50)).astype(np.float32)
    t = rng.integers(0, 50, (1, 12))
    t[0, :4] = [-1, 50, 57, chip_smoke.IGNORE]
    nll, kept, _ = chip_smoke._nll_oracle(torch.from_numpy(x), torch.from_numpy(t), slice(0, 12), 5)
    jm = JM.Perplexity(ignore_index=chip_smoke.IGNORE).update(x, t)
    assert kept == int(jm.num_total) == 11
    np.testing.assert_allclose(float(nll), float(jm.sum_log_probs), rtol=1e-6)
