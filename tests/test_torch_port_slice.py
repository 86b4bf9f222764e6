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


def test_phase_image_small_on_cpu():
    _kernels.reset_launch_counts()
    out = chip_smoke.phase_image(
        CPU, fid_images=16, fid_batch=8, vit_images=24, vit_batch=8, vit_size=32, vit_width=64,
        feature_images=2, psnr_pairs=5, psnr_hw=(24, 36), depth_maps=6, depth_hw=(16, 24),
        depth_outputs=8)
    assert out["k1_launches"] == 0
    fid = out["fid"]
    assert fid["conv_precision"] == "float32"  # no TF32 off the card
    for stream in ("inception", "vit_l"):
        report = fid[stream]
        assert report["fid"]["value"] > 0.1 * report["fid"]["trace_sum"]
        assert report["fid"]["err_rel_trace"] <= report["fid"]["bound_rel_trace"]
        assert report["fid"]["state_err_rel"] <= 1e-6
        off = report["fid"]["off_rel_trace"]
        assert off["cpu_float32"] == 0.0  # the "card" is the CPU here
        limit = chip_smoke.FID_LIMITS[stream]["float64_compute_of_float32_states"]
        assert 0.0 < off["float64_compute_of_float32_states"] <= limit
        for check in report["features"].values():
            assert check["rel_err_vs_float64"] <= check["tol"]
    assert abs(fid["inception"]["twice"]["float64"]) <= 1e-6 * fid["inception"]["twice"]["trace_sum"]
    assert max(out["psnr"]["rel_err_vs_float64"].values()) <= chip_smoke.IMAGE_TOL
    depth = out["depth"]
    assert depth["cat_bitwise"] and depth["pixels"] == 6 * 16 * 24
    assert max(depth["rel_err_vs_float64"].values()) <= chip_smoke.IMAGE_TOL
    assert len(depth["values"]["r2_raw"]) == 8 and 0.9 < depth["values"]["r2"] < 1.0
    assert out["auc"]["points"] == 5 and max(out["auc"]["rel_err_vs_float64"].values()) <= 1e-5


def test_fid_oracle_matches_the_jax_frechet_distance():
    """The smoke's float64 FID (numpy, from float64 sums) against the JAX
    package's ``_frechet_distance`` on the float32 states of the same
    activations."""
    from torcheval_tpu.metrics.image.fid import _frechet_distance

    rng = np.random.default_rng(8)
    sides, states = [], []
    for shift in (0.0, 0.3):
        a = np.abs(rng.standard_normal((300, 24)) + shift)
        a64 = torch.from_numpy(a.astype(np.float32)).double()
        sides.append([a.shape[0], a64.sum(0), a64.T @ a64, None, None])
        a32 = a.astype(np.float32)
        states += [a32.sum(0), a32.T @ a32, np.int32(a.shape[0])]
    fid64, trace, bound, extra = chip_smoke._fid64(*sides)
    want = float(_frechet_distance(*(jax.numpy.asarray(s) for s in states)))
    assert abs(fid64 - want) <= 1e-4 * trace and 0 < bound < trace
    assert 0 < extra["approx_bound_rel_trace"] * trace < bound
    # each witness of the float32 states against the JAX package's value
    witnesses = chip_smoke._fid_witnesses(tuple(torch.from_numpy(np.asarray(s)) for s in states))
    for value in witnesses.values():
        assert abs(value - want) <= 1e-4 * trace


def test_fid_stream_limits_can_fail():
    """The smoke's FID checks against the witnesses are live: at a limit
    of 0 the float32 value, which the float64 compute of its own states
    moves, is refused."""
    gen = torch.Generator().manual_seed(3)
    extractor = chip_smoke._PatchEmbedMean(8, torch.Generator().manual_seed(4))
    metric = TM.FrechetInceptionDistance(model=extractor, feature_dim=8, device=CPU)

    def frames(real, count):
        x = torch.rand((count, 3, 32, 32), generator=gen)
        return x if real else x * x

    limits = {"float64_compute_of_float32_states": 0.0, "cpu_float32": 0.0}
    with pytest.raises(AssertionError, match="float64_compute_of_float32_states"):
        chip_smoke._fid_stream("small", CPU, metric, extractor, frames, 64, 16, limits)


def test_phase_window_small_on_cpu():
    """The window phase at a small size: every check of the card run
    passes (values within WINDOW_TOL of float64, lifetimes bitwise to
    their twins, the replica sync equal to merge_state) and K1 stays
    idle."""
    out = chip_smoke.phase_window(
        CPU, n=60_000, batch=4096, window=5, wrap_cap=8192, over_cap=2048, world=4,
        mt_samples=1 << 12, num_tasks=4, mt_cap=1 << 10, num_classes=20, cls_batch=64,
        vocab=100, tokens=16, fid_images=1, reps=2)
    assert out["k1_launches"] == 0
    criteo = out["criteo"]
    assert max(criteo["value_rel_err_vs_float64"].values()) <= chip_smoke.WINDOW_TOL
    assert all(criteo["lifetime_bitwise_vs_twin"].values())
    sync = out["replica_sync"]
    assert sync["states_bitwise_vs_merge"] and sync["merged_samples"] == 4 * 8192
    assert max(out["tasks"]["value_rel_err_vs_float64"].values()) <= chip_smoke.WINDOW_TOL
    assert all(out["debug_tier"]["raised"].values()) and len(out["debug_tier"]["raised"]) == 8


def test_window_oracles_match_the_jax_metrics():
    """The smoke's float64 AUROC oracles agree with the JAX package's
    exact AUROC on weighted and tied samples."""
    rng = np.random.default_rng(4)
    s = np.round(rng.random((3, 400)), 2).astype(np.float32)
    y = (rng.random((3, 400)) < 0.4).astype(np.float32)
    w = rng.random((3, 400)).astype(np.float32)
    want = np.asarray(JM.BinaryAUROC(num_tasks=3).update(s, y, weight=w).compute())
    got = chip_smoke._weighted_auroc64(torch.from_numpy(s), torch.from_numpy(y),
                                       torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    ones = torch.ones(3, 400)
    np.testing.assert_allclose(
        chip_smoke._weighted_auroc64(torch.from_numpy(s), torch.from_numpy(y), ones).numpy(),
        chip_smoke._exact_oracle(torch.from_numpy(s), torch.from_numpy(y))[0].numpy(), rtol=1e-12)


def test_phase_bucket_small_on_cpu():
    """The bucket phase at a small size: every check of the card run that
    the CPU can make passes -- the bucketed classify panel bitwise equal to
    the eager unbucketed one after every update of a schedule whose buckets
    each see two valid counts, the Criteo panel's counters bitwise and its
    calibration rows within the float32 bound, perplexity within its
    float64 bound and equal to the eager stream, every remaining twin
    bitwise -- and nothing captures a CUDA graph or launches K1 here."""
    out = chip_smoke.phase_bucket(
        CPU, classify_n=700, num_classes=20, batch=64, variable=(64, 64, 60, 37, 32, 17, 7, 3),
        ctr_n=20_000, ctr_batch=4096, row_tasks=50, vocab=50, seqs=8, max_len=40, ppl_batches=5,
        chunk=64, twin_sizes=(64, 40, 3, 64), twin_classes=6, twin_thresholds=9, reps=2)
    classify = out["classify"]
    assert classify["stream_bitwise"] and classify["schedule_updates_bitwise"]
    assert set(classify["buckets_with_two_counts"]) == {"64", "32", "8"}
    assert classify["captures_first_pass"] == 0 and out["graph_stats"]["captures"] == 0
    assert classify["k1_launches"] == 0 and out["criteo"]["k1_launches"] == 0
    assert out["criteo"]["counters_bitwise"] and out["criteo"]["tail"] == 20_000 - 4 * 4096
    assert out["perplexity"]["rel_err_vs_eager"] <= 1e-6
    assert out["perplexity"]["rel_err_vs_float64"] <= out["perplexity"]["rel_bound_vs_float64"]
    assert all(out["twins"]["counters_bitwise"].values()) and len(out["twins"]["counters_bitwise"]) == 13
    assert out["streams"] is None  # two CUDA streams: a card check
