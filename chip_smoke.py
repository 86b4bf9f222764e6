#!/usr/bin/env python3
"""Drive torcheval_tpu_torch's eval-loop main path on one NVIDIA GPU.

Run from the root of a checkout with no arguments:

    python3 chip_smoke.py [--seed N]

It builds the CUDA kernels from ``torcheval_tpu_torch/ops/csrc/`` (one
``nvcc`` per source, into ``build/torcheval_tpu_torch/``), then runs these
phases, printing one JSON line for each:

1. ``classify``: an ImageNet-1k validation-scale stream (50,000 samples of
   1,000-class float32 logits in batches of 1,024) through
   ``toolkit.update_collection`` into micro and macro ``MulticlassAccuracy``
   and macro ``MulticlassF1Score``, with ``Mean`` over the batch loss and
   ``Throughput``; checked against a float64 oracle.
2. ``ctr_auc``: a Criteo 1TB evaluation-scale click stream (the 89,137,319
   samples MLPerf's DLRM-DCNv2 benchmark scores with AUC) in batches of
   65,536 through ``StreamingBinaryAUROC`` and ``StreamingBinaryAUPRC``
   (8192 bins, bounds (0, 1), unit weights), plus a 4-task weighted stream
   of 2^22 samples; the histograms are checked against a float64 oracle,
   the fused-AUC kernel must have launched once per update, and the
   stream must reach ``STREAM_RATE_FLOOR`` samples a second.
3. ``kernel_vs_plain``: the kernel wrapper against its plain PyTorch
   version on the same CUDA tensors, over sizes, task counts, score
   distributions, weights, bounds, NaN and empty inputs and bin counts, and
   what the kernel's float4 loads and cluster layout could break: scores
   one element off a 16-byte boundary, labels and weights broadcast over
   tasks, rows of 1 and 3 samples, 2 and 1,000 bins, every launch design
   forced at shapes where the wrapper would pick another. Bitwise equal on
   unit weights, within rtol 1e-5 with mass conserved on random weights.
4. ``sync``: four ``LocalReplicaGroup`` replicas on the card, each fed a
   quarter of smaller classify and click streams; the synced results must
   equal single-stream metrics bitwise. The sync is timed three times,
   each after the card's queue has drained.
5. ``curve``: the exact curve family over growable buffers. The Criteo
   stream of phase 2 feeds ``BinaryAUROC``, ``BinaryAUPRC`` and
   ``BinaryAUROC(use_fused=True)``; the exact values are held to float64
   oracles built apart from their cumsum/trapezoid chain (Mann-Whitney over
   mid-ranks, step-wise average precision) within ``CURVE_TOL``, and the
   fused value, whose compute launches K1 once, equals the plain histogram
   AUROC of the same buffers bitwise. An ImageNet-1k validation stream of
   softmax scores feeds ``MulticlassAUROC`` and ``MulticlassAUPRC``, each
   class held to the same oracles. Each compute's wall and device time,
   its costliest kernels, the buffers' bytes and the peak allocation are
   reported, with the reverse cummin timed in one and two levels.
6. ``mp_sync``: two spawned ranks, one process each, joined by gloo over a
   ``FileStore``, metric state on the card: each feeds its half of phase
   4's stream to that collection plus exact ``BinaryAUROC``/``BinaryAUPRC``
   and syncs over ``MultiHostGroup``. Every synced value and state equals
   one process's stream bitwise (the loss mean within 1e-6), a subgroup of
   rank 1 leaves rank 0 untouched, and the sync is timed three times from a
   drained queue.
7. ``timing``: the kernel against its plain version and ``torch.bincount``
   at the main path's shapes (T = 1 at 65,536 and 2^24 samples, and the
   weighted 4-task batch) and at 65,536 bins, with its device time from
   the profiler, its host time per call split three ways
   (``StreamingBinaryAUROC.update``, the checked wrapper, the bare C
   launch), the least time the memory traffic needs and the share of it
   reached; then a sweep of launch designs over batch sizes at 8,192 and
   65,536 bins, which holds the wrapper's pick against the designs on the
   other side of each of its switch points (``design_choices``).

Then a ``{"kernels": [...]}`` line, the card's name and power limit as
``nvidia-smi`` reports them, and, last, ``{"ok": true, "device": {...}}``.
Any failure raises, and the script exits non-zero without that last line;
without a CUDA device it exits non-zero at once.

The phase functions take ``device`` and sizes, so the CPU tests run phases
1, 2 and 4 to 6 at small sizes with ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torcheval_tpu_torch.distributed import LocalReplicaGroup, MultiHostGroup  # noqa: E402
from torcheval_tpu_torch.metrics import (  # noqa: E402
    BinaryAUPRC,
    BinaryAUROC,
    Mean,
    MulticlassAccuracy,
    MulticlassAUPRC,
    MulticlassAUROC,
    MulticlassF1Score,
    StreamingBinaryAUPRC,
    StreamingBinaryAUROC,
    Throughput,
)
from torcheval_tpu_torch.metrics import toolkit  # noqa: E402
from torcheval_tpu_torch.metrics.functional.classification._curve_kernels import (  # noqa: E402
    _reverse_cummin,
)
from torcheval_tpu_torch.metrics.functional.classification.auprc import (  # noqa: E402
    _multiclass_auprc_compute,
)
from torcheval_tpu_torch.metrics.functional.classification.auroc import (  # noqa: E402
    _multiclass_auroc_compute,
)
from torcheval_tpu_torch.ops import _kernels  # noqa: E402
fa = importlib.import_module("torcheval_tpu_torch.ops.fused_auc")  # the module, not ops.fused_auc
from torcheval_tpu_torch.ops.fused_auc import (  # noqa: E402
    K1Geometry,
    _auc_from_hist,
    _auprc_from_hist,
    _histogram_cuda,
    _histogram_plain_full,
    _prepare_scores,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
NUM_BINS = 8192
IMAGENET_VAL = 50_000
CRITEO_EVAL = 89_137_319
CTR_BATCH = 65_536
# the least ctr_auc stream rate on a card: a Criteo 1TB evaluation pass
# within a second of metric time
STREAM_RATE_FLOOR = 1e8
# exact curve values against their float64 oracles: float32 counts are
# exact below 2^24, and past it (Criteo's negatives) a cumulative count is
# off by a few units in its last place, ~1e-7 of the area
CURVE_TOL = 1e-5


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ------------------------------------------------------------------ data


def _classify_batch(gen, n, num_classes, device):
    """Logits with the true class raised by 3.5 (top-1 near ImageNet
    classifiers'), and uniform labels."""
    logits = torch.randn(n, num_classes, generator=gen, device=device)
    labels = torch.randint(0, num_classes, (n,), generator=gen, device=device)
    logits[torch.arange(n, device=device), labels] += 3.5
    return logits, labels


def _scores(gen, shape, skewed, device):
    """Scores in [0, 1]: uniform, or a skewed CTR-like logit-normal draw
    (sigmoid of N(-3.5, 1.5): median ~0.03, most mass near 0)."""
    if skewed:
        return torch.sigmoid(torch.randn(shape, generator=gen, device=device) * 1.5 - 3.5)
    return torch.rand(shape, generator=gen, device=device)


def _clicks(gen, shape, device):
    s = _scores(gen, shape, True, device)
    y = (torch.rand(shape, generator=gen, device=device) < s).to(torch.float32)
    return s, y


def _oracle_hist(scores, labels, weights, num_bins):
    """float64 histogram, by the port's bin rule, of scores already mapped
    to [0, 1] (as with bounds (0, 1))."""
    t, _ = scores.shape
    s = torch.nan_to_num(scores.clamp(0.0, 1.0), nan=0.0)
    bins = torch.clamp((s * num_bins).to(torch.int64), max=num_bins - 1)
    flat = (bins + torch.arange(t, device=scores.device)[:, None] * num_bins).reshape(-1)
    w = torch.ones_like(scores, dtype=torch.float64) if weights is None else weights.double()
    y = labels.double()
    pos = torch.bincount(flat, weights=(w * y).reshape(-1), minlength=t * num_bins)
    neg = torch.bincount(flat, weights=(w * (1 - y)).reshape(-1), minlength=t * num_bins)
    return torch.stack([pos.reshape(t, num_bins), neg.reshape(t, num_bins)], dim=1)


def _auc64(hist):
    return _auc_from_hist(hist.double())


def _auprc64(hist):
    return _auprc_from_hist(hist.double())


# ---------------------------------------------------------------- phases


def phase_classify(device, n=IMAGENET_VAL, num_classes=1000, batch=1024, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    cls = {
        "acc": MulticlassAccuracy(device=device),
        "acc_macro": MulticlassAccuracy(average="macro", num_classes=num_classes, device=device),
        "f1_macro": MulticlassF1Score(num_classes=num_classes, average="macro", device=device),
    }
    loss, tput = Mean(device=device), Throughput(device=device)
    losses, batch_ms = [], []
    t_start = time.perf_counter()
    for start in range(0, n, batch):
        t0 = time.perf_counter()
        b = min(batch, n - start)
        logits, labels = _classify_batch(gen, b, num_classes, device)
        batch_loss = F.cross_entropy(logits, labels)
        toolkit.update_collection(cls, logits, labels)
        loss.update(batch_loss)
        losses.append(batch_loss)
        _sync(device)
        dt = time.perf_counter() - t0
        tput.update(b, dt)
        batch_ms.append(dt * 1e3)
    seconds = time.perf_counter() - t_start

    # oracle pass: the same batches regenerated from the seed
    gen = torch.Generator(device=device).manual_seed(seed)
    preds, labels_all = [], []
    for start in range(0, n, batch):
        logits, labels = _classify_batch(gen, min(batch, n - start), num_classes, device)
        preds.append(logits.double().argmax(dim=-1))
        labels_all.append(labels)
    pred, lab = torch.cat(preds), torch.cat(labels_all)
    correct = (pred == lab).double()
    per_total = torch.bincount(lab, minlength=num_classes).double()
    per_correct = torch.bincount(lab, weights=correct, minlength=num_classes)
    per_pred = torch.bincount(pred, minlength=num_classes).double()
    seen = per_total > 0
    acc_macro = (per_correct[seen] / per_total[seen]).mean()
    prec = torch.nan_to_num(per_correct / per_pred)
    rec = torch.nan_to_num(per_correct / per_total)
    f1 = torch.nan_to_num(2 * prec * rec / (prec + rec))
    f1_mask = seen | (per_pred > 0)
    oracle = {
        "acc": float(correct.mean()),
        "acc_macro": float(acc_macro),
        "f1_macro": float(f1[f1_mask].mean()),
        "loss": float(torch.stack(losses).double().mean()),
    }
    got = {name: float(m.compute()) for name, m in cls.items()}
    got["loss"] = float(loss.compute())
    err = {k: abs(got[k] - oracle[k]) for k in oracle}
    _check(float(cls["acc"].num_correct) == float(correct.sum()), "acc counter != oracle")
    _check(float(cls["acc"].num_total) == float(n), "acc total != n")
    _check(
        torch.equal(cls["acc_macro"].num_correct.double(), per_correct),
        "per-class correct counts != oracle",
    )
    _check(
        torch.equal(cls["f1_macro"].num_prediction.double(), per_pred),
        "per-class prediction counts != oracle",
    )
    _check(all(e <= 1e-5 for e in err.values()), f"classify values off the oracle: {err}")
    _check(math.isfinite(tput.compute()) and tput.compute() > 0, "throughput not positive")
    return {
        "phase": "classify", "device": str(device), "samples": n,
        "num_classes": num_classes, "batch": batch, "values": got,
        "max_err_vs_float64": max(err.values()), "seconds": seconds,
        "samples_per_s": n / seconds, "throughput_metric": tput.compute(),
        "batch_ms_first": batch_ms[0],
        "batch_ms_median": sorted(batch_ms)[len(batch_ms) // 2],
    }


def phase_ctr_auc(device, n=CRITEO_EVAL, batch=CTR_BATCH, num_bins=NUM_BINS,
                  mt_samples=1 << 22, num_tasks=4, seed=1):
    cuda = torch.device(device).type == "cuda"
    auroc = StreamingBinaryAUROC(num_bins=num_bins, device=device)
    auprc = StreamingBinaryAUPRC(num_bins=num_bins, device=device)
    mt = StreamingBinaryAUROC(num_tasks=num_tasks, num_bins=num_bins, device=device)
    mt_batch = min(batch, mt_samples)

    _kernels.reset_launch_counts()
    _sync(device)
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(seed)
    updates = 0
    for start in range(0, n, batch):
        s, y = _clicks(gen, (min(batch, n - start),), device)
        auroc.update(s, y)
        auprc.update(s, y)
        updates += 2
    _sync(device)
    seconds = time.perf_counter() - t0
    for _ in range(0, mt_samples, mt_batch):
        s, y = _clicks(gen, (num_tasks, mt_batch), device)
        w = torch.rand((num_tasks, mt_batch), generator=gen, device=device)
        mt.update(s, y, w)
        updates += 1
    _sync(device)
    launches = _kernels.LAUNCHES["fused_auc_hist"]
    if cuda:
        _check(launches == updates, f"K1 launched {launches} times for {updates} updates")
        _check(n / seconds >= STREAM_RATE_FLOOR,
               f"AUC stream at {n / seconds:.3g} samples/s, under {STREAM_RATE_FLOOR:.0e}")

    # oracle pass: the same batches regenerated from the seed
    gen = torch.Generator(device=device).manual_seed(seed)
    ref = torch.zeros((1, 2, num_bins), dtype=torch.float64, device=device)
    for start in range(0, n, batch):
        s, y = _clicks(gen, (min(batch, n - start),), device)
        ref += _oracle_hist(s[None], y[None], None, num_bins)
    ref_mt = torch.zeros((num_tasks, 2, num_bins), dtype=torch.float64, device=device)
    for _ in range(0, mt_samples, mt_batch):
        s, y = _clicks(gen, (num_tasks, mt_batch), device)
        w = torch.rand((num_tasks, mt_batch), generator=gen, device=device)
        ref_mt += _oracle_hist(s, y, w, num_bins)

    # unit weights, every bin < 2^24: the float32 state is exact
    _check(bool((ref < 2**24).all()), "a bin reached 2^24; exactness does not hold")
    _check(torch.equal(auroc.hist.double(), ref), "unit-weight histogram != float64 oracle")
    _check(torch.equal(auprc.hist, auroc.hist), "AUROC and AUPRC states differ")
    mt_rel = float(((mt.hist.double() - ref_mt).abs() / ref_mt.abs().clamp(min=1e-30)).max())
    mass_rel = float((mt.hist.double().sum() - ref_mt.sum()).abs() / ref_mt.sum())
    _check(mt_rel <= 1e-5 and mass_rel <= 1e-5, f"weighted histogram rel err {mt_rel}, mass {mass_rel}")
    values = {
        "auroc": float(auroc.compute()), "auprc": float(auprc.compute()),
        "auroc_tasks": mt.compute().tolist(),
    }
    oracle = {
        "auroc": float(_auc64(ref)[0]), "auprc": float(_auprc64(ref)[0]),
        "auroc_tasks": _auc64(ref_mt).tolist(),
    }
    err = max(
        abs(values["auroc"] - oracle["auroc"]),
        abs(values["auprc"] - oracle["auprc"]),
        max(abs(a - b) for a, b in zip(values["auroc_tasks"], oracle["auroc_tasks"])),
    )
    _check(err <= 1e-5, f"AUC values off the float64 oracle by {err}")
    return {
        "phase": "ctr_auc", "device": str(device), "samples": n, "batch": batch,
        "num_bins": num_bins, "weighted_tasks": num_tasks,
        "weighted_samples_per_task": mt_samples, "updates": updates,
        "k1_launches": launches, "values": values, "max_err_vs_float64": err,
        "weighted_hist_max_rel_err": mt_rel,
        "stream_seconds": seconds, "stream_samples_per_s": n / seconds,
    }


def _k1_design(n, tasks, num_bins, geometry=None):
    """The geometry the wrapper picks for this shape (or ``geometry``), as
    the smoke reports it."""
    if geometry is None:
        geometry = fa._geometry(_kernels.load("fused_auc_hist"), torch.cuda.current_device(),
                                n, tasks, num_bins)
    mode = "split" if geometry.split else ("replicated" if geometry.shared else "global")
    return {"cluster": geometry.cluster, "clusters_per_task": geometry.clusters_per_task,
            "smem_bytes": geometry.smem_bytes, "mode": mode}


def _kernel_case(gen, n, tasks, skewed, weighted, bounds, num_bins, device, nan=False,
                 offset=0, broadcast=False, geometry=None, soft=0.0):
    """One kernel-vs-plain comparison on the same CUDA tensors.

    ``offset`` places the scores at that many elements past a 16-byte
    boundary (a view into a larger buffer, so float4 loads must not be
    taken for the head); ``broadcast`` makes labels and weights one row
    expanded over the tasks (row stride 0); ``geometry`` forces a launch
    design instead of the wrapper's choice; ``soft`` makes that share of
    the labels fractional (the unit-weight kernel counts 0/1 labels and
    adds any other label's float masses apart).

    Unit weights: the two must be bitwise equal. Random weights: float
    atomics add in a run-dependent order, so the kernel is held to the
    float64 histogram of the same bins (per-bin rtol 1e-5, and the total
    mass within rtol 1e-5), and its difference from the plain version must
    stay within rtol 1e-5 of the plain value plus the plain version's own
    float32 accumulation error against float64 (the plain scatter adds a
    bin's samples one after another, so a bin with tens of thousands of
    samples drifts past 1e-5 on its own)."""
    base = _scores(gen, (tasks, n), skewed, device)
    if bounds is None:
        raw = base * 80.0 - 40.0  # logit-like range, normalized per task
    else:
        lo, hi = bounds
        raw = lo + base * (hi - lo)
        raw[:, 7::101] = lo - 1.0  # a sparse few past both edges: clamped
        raw[:, 57::101] = hi + 1.0
    if nan:
        raw[:, ::97] = float("nan")
    if offset:
        buf = torch.empty(tasks * n + offset, device=device)
        buf[offset:] = raw.reshape(-1)
        raw = buf[offset:].view(tasks, n)
    rows = 1 if broadcast else tasks
    labels = (torch.rand((rows, n), generator=gen, device=device) < base[:rows]).to(torch.float32)
    if soft:
        fractional = torch.rand((rows, n), generator=gen, device=device) < soft
        labels = torch.where(fractional, torch.rand((rows, n), generator=gen, device=device), labels)
    weights = torch.rand((rows, n), generator=gen, device=device) if weighted else None
    if broadcast:
        labels = labels.expand(tasks, n)
        weights = None if weights is None else weights.expand(tasks, n)
    out = torch.zeros((tasks, 2, num_bins), dtype=torch.float32, device=device)
    before = _kernels.LAUNCHES["fused_auc_hist"]
    _histogram_cuda(out, raw, labels, weights, num_bins, bounds, geometry)
    plain = _histogram_plain_full(raw, labels, weights, num_bins, bounds)
    _sync(device)
    _check(
        _kernels.LAUNCHES["fused_auc_hist"] == before + (1 if n else 0),
        "wrapper launch count wrong",
    )
    abs_err = float((out - plain).abs().max()) if out.numel() else 0.0
    rel = plain_rel = mass = 0.0
    if weighted or soft:
        ref = _oracle_hist(_prepare_scores(raw, bounds), labels, weights, num_bins)
        scale = ref.abs().clamp(min=1e-30)
        rel = float(((out.double() - ref).abs() / scale).max())
        plain_err = (plain.double() - ref).abs()
        plain_rel = float((plain_err / scale).max())
        mass = abs(float(out.double().sum() - ref.sum())) / float(ref.sum())
        explained = (out.double() - plain.double()).abs() <= 1e-5 * plain.double().abs() + plain_err
        ok = rel <= 1e-5 and mass <= 1e-5 and bool(explained.all())
    else:
        ok = torch.equal(out, plain)
    case = {
        "n": n, "tasks": tasks, "skewed": skewed, "weighted": weighted,
        "bounds": bounds, "num_bins": num_bins, "nan": nan, "offset": offset,
        "broadcast": broadcast, "soft": soft,
        "design": _k1_design(n, tasks, num_bins, geometry) if n else None,
        "max_abs_err": abs_err, "max_rel_err_vs_float64": rel,
        "plain_max_rel_err_vs_float64": plain_rel, "mass_rel_err": mass,
    }
    _check(ok, f"kernel != plain: {case}")
    return case


def phase_kernel_vs_plain(device, seed=2):
    gen = torch.Generator(device=device).manual_seed(seed)
    all_bounds = [(0.0, 1.0), (-3.0, 5.0), None]
    cases = []
    for n in (4097, 65_536, 1 << 24):
        for tasks in (1, 4):
            for skewed in (False, True):
                for weighted in (False, True):
                    for bounds in all_bounds:
                        cases.append(_kernel_case(gen, n, tasks, skewed, weighted,
                                                  bounds, NUM_BINS, device))
    for num_bins in (512, 65_536):
        for tasks in (1, 4):
            for weighted in (False, True):
                for bounds in all_bounds:
                    cases.append(_kernel_case(gen, 65_536, tasks, True, weighted,
                                              bounds, num_bins, device))
    for bounds in all_bounds:
        for tasks in (1, 4):
            cases.append(_kernel_case(gen, 65_536, tasks, False, False, bounds,
                                      NUM_BINS, device, nan=True))
    for tasks in (1, 4):
        cases.append(_kernel_case(gen, 0, tasks, False, False, (0.0, 1.0), NUM_BINS, device))
    # what vector loads and the cluster layout can break: tiny rows and
    # bin counts below or not a multiple of the cluster size
    for i, (n, num_bins) in enumerate((n, b) for n in (1, 3, 4097) for b in (2, 1000)):
        for tasks in (1, 4):
            for weighted in (False, True):
                cases.append(_kernel_case(gen, n, tasks, True, weighted, all_bounds[i % 3],
                                          num_bins, device))
    # scores one element past a 16-byte boundary
    for n in (4097, 65_536, 1 << 24):
        for tasks in (1, 4):
            for weighted in (False, True):
                cases.append(_kernel_case(gen, n, tasks, True, weighted, (0.0, 1.0),
                                          NUM_BINS, device, offset=1))
    # labels and weights broadcast over 4 tasks (row stride 0)
    for n, offset in ((4097, 0), (65_536, 0), (65_537, 0), (65_537, 1), (1 << 22, 0)):
        for weighted in (False, True):
            cases.append(_kernel_case(gen, n, 4, True, weighted, (0.0, 1.0), NUM_BINS,
                                      device, offset=offset, broadcast=True))
    # 65,536 bins with several clusters a task; 2^20 bins: the global variant
    for num_bins, n in ((65_536, 1 << 22), (1 << 20, 65_536)):
        for tasks in (1, 4):
            for weighted in (False, True):
                cases.append(_kernel_case(gen, n, tasks, True, weighted, (0.0, 1.0),
                                          num_bins, device))
    # fractional labels under unit weights: all of them, or a sparse few
    for n in (4097, 65_536, 1 << 22):
        for tasks in (1, 4):
            for soft in (1.0, 0.01):
                cases.append(_kernel_case(gen, n, tasks, True, False, (0.0, 1.0), NUM_BINS,
                                          device, soft=soft))
    # every design at shapes where the wrapper would pick another
    for n in (4097, 65_536, 1 << 22):
        for geometry in (K1Geometry(1, 1, 65536), K1Geometry(1, 16, 65536),
                         K1Geometry(2, 8, 65536), K1Geometry(4, 1, 65536),
                         K1Geometry(16, 1, 65536), K1Geometry(8, 5, 8192, True),
                         K1Geometry(16, 1, 4096, True), K1Geometry(16, 3, 4096, True)):
            for weighted in (False, True):
                cases.append(_kernel_case(gen, n, 4, True, weighted, (0.0, 1.0), NUM_BINS,
                                          device, geometry=geometry))
    return {
        "phase": "kernel_vs_plain", "cases": len(cases),
        "bitwise_cases": sum(1 for c in cases if not (c["weighted"] or c["soft"])),
        "designs": sorted({json.dumps(c["design"], sort_keys=True) for c in cases if c["design"]}),
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "max_rel_err_vs_float64": max(c["max_rel_err_vs_float64"] for c in cases),
        "plain_max_rel_err_vs_float64": max(c["plain_max_rel_err_vs_float64"] for c in cases),
        "max_mass_rel_err": max(c["mass_rel_err"] for c in cases),
    }


def _sync_collection(device, num_classes, exact=False):
    """The sync phases' collection; ``exact`` adds the buffered
    ``BinaryAUROC``/``BinaryAUPRC`` over the click stream."""
    coll = {
        "acc": MulticlassAccuracy(device=device),
        "acc_macro": MulticlassAccuracy(average="macro", num_classes=num_classes, device=device),
        "f1_macro": MulticlassF1Score(num_classes=num_classes, average="macro", device=device),
        "loss": Mean(device=device),
        "auroc": StreamingBinaryAUROC(device=device),
        "auprc": StreamingBinaryAUPRC(device=device),
    }
    if exact:
        coll["exact_auroc"] = BinaryAUROC(device=device)
        coll["exact_auprc"] = BinaryAUPRC(device=device)
    return coll


_CLASSIFY_NAMES = ("acc", "acc_macro", "f1_macro")


def _feed_sync_stream(colls, device, seed, classify_n, num_classes, batch, ctr_n, ctr_batch):
    """Feed the sync phases' stream (classify batches, then click batches,
    from one generator) to ``colls(i)``: the collections batch ``i`` goes
    to, each updating the members it has. Returns the number of click
    batches."""
    gen = torch.Generator(device=device).manual_seed(seed)
    for i, start in enumerate(range(0, classify_n, batch)):
        logits, labels = _classify_batch(gen, min(batch, classify_n - start), num_classes, device)
        batch_loss = F.cross_entropy(logits, labels)
        for coll in colls(i):
            toolkit.update_collection(
                {k: coll[k] for k in _CLASSIFY_NAMES if k in coll}, logits, labels)
            if "loss" in coll:
                coll["loss"].update(batch_loss)
    clicks = 0
    for i, start in enumerate(range(0, ctr_n, ctr_batch)):
        s, y = _clicks(gen, (min(ctr_batch, ctr_n - start),), device)
        for coll in colls(i):
            names = [k for k in ("auroc", "auprc", "exact_auroc", "exact_auprc") if k in coll]
            toolkit.update_collection({k: coll[k] for k in names}, s, y)
        clicks += 1
    return clicks


def phase_sync(device, classify_n=8192, num_classes=1000, batch=1024,
               ctr_n=1 << 22, ctr_batch=CTR_BATCH, world=4, seed=3):
    group = LocalReplicaGroup([torch.device(device)] * world)
    single = _sync_collection(device, num_classes)
    replicas = [_sync_collection(device, num_classes) for _ in range(world)]
    _feed_sync_stream(lambda i: (single, replicas[i % world]), device, seed,
                      classify_n, num_classes, batch, ctr_n, ctr_batch)
    # timed from a drained queue: the replicas' updates are not the sync's
    seconds = []
    for _ in range(3):
        _sync(device)
        t0 = time.perf_counter()
        synced = toolkit.get_synced_metric_collection(replicas, group)
        values = {name: m.compute() for name, m in synced.items()}
        _sync(device)
        seconds.append(time.perf_counter() - t0)
    expected = {name: m.compute() for name, m in single.items()}
    for name in ("acc", "acc_macro", "f1_macro", "auroc", "auprc"):
        for state in synced[name].state_dict():
            _check(
                torch.equal(getattr(synced[name], state), getattr(single[name], state)),
                f"synced {name}.{state} != single stream",
            )
        _check(torch.equal(values[name], expected[name]), f"synced {name} != single stream")
    loss_err = float((values["loss"] - expected["loss"]).abs())
    _check(loss_err <= 1e-6 * max(1.0, float(expected["loss"].abs())), f"loss off by {loss_err}")
    return {
        "phase": "sync", "device": str(device), "world": world,
        "classify_samples": classify_n, "ctr_samples": ctr_n,
        "values": {k: float(v) for k, v in values.items()},
        "bitwise": ["acc", "acc_macro", "f1_macro", "auroc", "auprc"],
        "loss_abs_err": loss_err, "sync_seconds": sorted(seconds)[1],
        "sync_seconds_runs": seconds,
    }


# ----------------------------------------------------------- exact curves


def _exact_oracle(scores, labels):
    """float64 exact AUROC and average precision of each row of (R, n)
    scores with 0/1 labels, from integer counts of each tie group, apart
    from the metrics' cumsum/trapezoid chain: AUROC is the Mann-Whitney
    statistic over mid-ranks, ``(R+ - P(P+1)/2) / (P N)``; average
    precision sums, over the distinct thresholds from the top, each one's
    recall step times its precision. NaN for a row without positives or
    without negatives."""
    rows, n = scores.shape
    s, order = torch.sort(scores, dim=-1)
    y = torch.gather(labels.to(torch.int64), 1, order).reshape(-1)
    new = torch.ones_like(s, dtype=torch.bool)
    new[:, 1:] = s[:, 1:] != s[:, :-1]
    new = new.reshape(-1)
    gid = torch.cumsum(new, 0) - 1  # tie groups, numbered across rows
    groups = int(gid[-1]) + 1
    cnt = torch.bincount(gid, minlength=groups)
    pos = torch.zeros(groups, dtype=torch.int64, device=s.device).index_add_(0, gid, y)
    row = torch.arange(rows, device=s.device).repeat_interleave(n)[new]
    first_gid = gid[torch.arange(rows, device=s.device) * n]
    cnt_below = torch.cumsum(cnt, 0) - cnt  # samples in lower groups (all rows)
    pos_below = torch.cumsum(pos, 0) - pos
    cnt_below = cnt_below - cnt_below[first_gid][row]  # ... of this row
    pos_below = pos_below - pos_below[first_gid][row]
    p = labels.to(torch.int64).sum(-1)
    neg = n - p
    midrank = cnt_below.double() + (cnt.double() + 1.0) / 2.0
    rank_sum = torch.zeros(rows, dtype=torch.float64, device=s.device).index_add_(
        0, row, midrank * pos.double())
    pd, nd = p.double(), neg.double()
    auroc = (rank_sum - pd * (pd + 1.0) / 2.0) / (pd * nd)
    tp = p[row] - pos_below  # samples at or above the group's threshold
    fp = neg[row] - (cnt_below - pos_below)
    ap = torch.zeros(rows, dtype=torch.float64, device=s.device).index_add_(
        0, row, pos.double() * tp.double() / (tp + fp).double()) / pd
    bad = (p == 0) | (neg == 0)
    nan = torch.full_like(auroc, float("nan"))
    return torch.where(bad, nan, auroc), torch.where(bad, nan, ap)


def _profile(fn, device):
    """Device time of one call of ``fn`` (every CUDA kernel's self time
    in a torch.profiler trace) and its five costliest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        _sync(device)
    kernels = []
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            us = getattr(evt, "self_device_time_total", None)
            if us is None:
                us = evt.self_cuda_time_total
            kernels.append((us / 1e3, evt.count, evt.key))
    kernels.sort(reverse=True)
    _check(bool(kernels) and kernels[0][0] > 0, "profiler shows no device time")
    return {"device_ms": sum(k[0] for k in kernels),
            "top_kernels": [[k[2][:80], k[0], k[1]] for k in kernels[:5]]}


def _timed_compute(metric, device):
    """One ``compute()`` from a drained queue, timed to its result."""
    _sync(device)
    t0 = time.perf_counter()
    value = metric.compute()
    _sync(device)
    return value, time.perf_counter() - t0


def _buffer_bytes(*metrics):
    return sum(getattr(m, name).numel() * getattr(m, name).element_size()
               for m in metrics for name in m._buffer_specs)


def phase_curve(device, n=CRITEO_EVAL, batch=CTR_BATCH, cls_n=IMAGENET_VAL,
                num_classes=1000, cls_batch=1024, num_bins=NUM_BINS, seed=5):
    """Exact AUROC/AUPRC over growable buffers at Criteo 1TB evaluation
    scale, plus the fused histogram AUROC on the same stream, and the
    multiclass pair over ImageNet-1k validation; each held to a float64
    oracle."""
    cuda = torch.device(device).type == "cuda"
    auroc = BinaryAUROC(device=device)
    auprc = BinaryAUPRC(device=device)
    fused = BinaryAUROC(use_fused=True, device=device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    _sync(device)
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(seed)
    for start in range(0, n, batch):
        s, y = _clicks(gen, (min(batch, n - start),), device)
        for m in (auroc, auprc, fused):
            m.update(s, y)
    _sync(device)
    stream_seconds = time.perf_counter() - t0
    buffer_bytes = _buffer_bytes(auroc, auprc, fused)

    before = _kernels.LAUNCHES["fused_auc_hist"]
    values, wall = {}, {}
    for name, m in (("auroc", auroc), ("auprc", auprc), ("auroc_fused", fused)):
        values[name], wall[name] = _timed_compute(m, device)
    launches = _kernels.LAUNCHES["fused_auc_hist"] - before
    # once more: the first computes also load kernels and grow the allocator
    warm = {name: _timed_compute(m, device)[1]
            for name, m in (("auroc", auroc), ("auprc", auprc), ("auroc_fused", fused))}
    _check(launches == (1 if cuda else 0), f"the fused compute launched K1 {launches} times")
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    profiles, cummin_ms = {}, {}
    if cuda:
        for name, m in (("auroc", auroc), ("auprc", auprc), ("auroc_fused", fused)):
            profiles[name] = _profile(m.compute, device)
        # both sides of the reverse cummin's design: one sequential scan of
        # the 2^27-slot row against the two-level scan the metrics run
        row = auroc.inputs
        cummin_ms = {
            "one_level": _time_ms(lambda: torch.cummin(torch.flip(row, (-1,)), -1), device, 1),
            "two_level": _time_ms(lambda: _reverse_cummin(row), device, 5),
        }

    # the fused value against the plain histogram of the same valid samples
    inputs, targets, weights = (b[None] for b in fused._valid())
    plain_hist = _histogram_plain_full(inputs, targets, weights, num_bins, None)
    kernel_hist = fa.histogram_delta_kernel(inputs, targets, weights, num_bins, None)
    _check(torch.equal(kernel_hist, plain_hist), "fused compute's histogram != plain version")
    _check(torch.equal(values["auroc_fused"], _auc_from_hist(plain_hist)[0]),
           "fused AUROC != plain histogram AUROC")
    del inputs, targets, weights, plain_hist, kernel_hist

    gen = torch.Generator(device=device).manual_seed(seed)
    stream = [_clicks(gen, (min(batch, n - start),), device) for start in range(0, n, batch)]
    scores = torch.cat([s for s, _ in stream])[None]
    clicks = torch.cat([y for _, y in stream])[None]
    del stream
    o_auroc, o_auprc = (float(v[0]) for v in _exact_oracle(scores, clicks))
    del scores, clicks
    err = {"auroc": abs(float(values["auroc"]) - o_auroc),
           "auprc": abs(float(values["auprc"]) - o_auprc)}
    _check(max(err.values()) <= CURVE_TOL, f"exact curve values off the float64 oracle: {err}")
    criteo = {
        "samples": n, "batch": batch, "stream_seconds": stream_seconds,
        "capacity": auroc.inputs.shape[-1], "buffer_bytes": buffer_bytes,
        "peak_bytes": peak, "values": {k: float(v) for k, v in values.items()},
        "oracle": {"auroc": o_auroc, "auprc": o_auprc}, "err_vs_float64": err,
        "fused_minus_exact": float(values["auroc_fused"]) - o_auroc,
        "compute_wall_s": wall, "compute_wall_s_warm": warm, "compute_profile": profiles,
        "reverse_cummin_ms": cummin_ms,
    }
    del auroc, auprc, fused, values

    mc_auroc = MulticlassAUROC(num_classes=num_classes, device=device)
    mc_auprc = MulticlassAUPRC(num_classes=num_classes, device=device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    probs_all, labels_all = [], []
    for start in range(0, cls_n, cls_batch):
        logits, labels = _classify_batch(gen, min(cls_batch, cls_n - start), num_classes, device)
        probs = torch.softmax(logits, dim=-1)
        mc_auroc.update(probs, labels)
        mc_auprc.update(probs, labels)
        probs_all.append(probs)
        labels_all.append(labels)
    cls_values, cls_wall, cls_profiles = {}, {}, {}
    for name, m in (("auroc_macro", mc_auroc), ("auprc_macro", mc_auprc)):
        cls_values[name], cls_wall[name] = _timed_compute(m, device)
        if cuda:
            cls_profiles[name] = _profile(m.compute, device)
    inputs, targets = mc_auroc._padded()
    per_auroc = _multiclass_auroc_compute(inputs, targets, mc_auroc._valid_mask(inputs.shape[0]))
    per_auprc = _multiclass_auprc_compute(*mc_auprc._padded())
    _check(torch.equal(torch.mean(per_auroc), cls_values["auroc_macro"])
           and torch.equal(torch.mean(per_auprc), cls_values["auprc_macro"]),
           "macro values != the mean of the per-class values")
    probs = torch.cat(probs_all)
    labels = torch.cat(labels_all)
    onehot = labels[None, :] == torch.arange(num_classes, device=device)[:, None]
    o_auroc, o_auprc = _exact_oracle(probs.T, onehot)
    scored = ~torch.isnan(o_auroc)
    _check(bool(scored.any()), "no class has both positives and negatives")
    cls_err = {
        "auroc": float((per_auroc.double() - o_auroc)[scored].abs().max()),
        "auprc": float((per_auprc.double() - o_auprc)[scored].abs().max()),
    }
    _check(max(cls_err.values()) <= CURVE_TOL,
           f"per-class curve values off the float64 oracle: {cls_err}")
    imagenet = {
        "samples": cls_n, "num_classes": num_classes, "batch": cls_batch,
        "classes_scored": int(scored.sum()),
        "values": {k: float(v) for k, v in cls_values.items()},
        "max_class_err_vs_float64": cls_err, "compute_wall_s": cls_wall,
        "compute_profile": cls_profiles,
    }
    return {"phase": "curve", "device": str(device), "k1_launches": launches,
            "criteo": criteo, "imagenet": imagenet}


# ------------------------------------------------------ multi-process sync


def _spawn_ranks(target, world, args, timeout):
    """Run ``target(rank, world, *args)`` in ``world`` spawned processes
    and wait for them all. A rank that exits non-zero, or the timeout,
    ends the others at once and raises; no process outlives the call."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(rank, world, *args)) for rank in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise RuntimeError(f"spawned ranks exited with {codes} (timeout {timeout} s)")


def _cpu_states(state_dicts):
    return {name: {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in sd.items()}
            for name, sd in state_dicts.items()}


def _same_state(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    return type(a) is type(b) and a == b


def _mp_rank(rank, world, device, out_dir, sizes, seed):
    """One rank of ``phase_mp_sync``: its share of the sync stream, then
    the syncs, written to ``out_dir/rank<r>.pt``."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(out_dir, "store"), world),
                            rank=rank, world_size=world)
    try:
        coll = _sync_collection(device, sizes["num_classes"], exact=True)
        _kernels.reset_launch_counts()
        clicks = _feed_sync_stream(
            lambda i: (coll,) if i % world == rank else (), device, seed, sizes["classify_n"],
            sizes["num_classes"], sizes["batch"], sizes["ctr_n"], sizes["ctr_batch"])
        launches = _kernels.LAUNCHES["fused_auc_hist"]
        group = MultiHostGroup()
        values = toolkit.sync_and_compute_collection(coll, group)
        state_dicts = toolkit.get_synced_state_dict_collection(coll, group)
        seconds = []
        for _ in range(3):
            _sync(device)
            t0 = time.perf_counter()
            synced = toolkit.get_synced_metric_collection(coll, group)
            for m in synced.values():
                m.compute()
            _sync(device)
            seconds.append(time.perf_counter() - t0)
        sub = group.new_subgroup([1])
        before = {name: m.state_dict() for name, m in coll.items()}
        untouched = toolkit.get_synced_metric_collection(coll, sub) is coll and all(
            _same_state(v, getattr(coll[name], k))
            for name, sd in before.items() for k, v in sd.items())
        torch.save({
            "values": {k: v.cpu() for k, v in values.items()},
            "state_dicts": _cpu_states(state_dicts), "seconds": seconds,
            "launches": launches, "clicks": (clicks - rank + world - 1) // world,
            "sub_member": sub.is_member, "sub_untouched": untouched,
        }, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def phase_mp_sync(device, classify_n=8192, num_classes=1000, batch=1024,
                  ctr_n=1 << 22, ctr_batch=CTR_BATCH, world=2, seed=6, timeout=600):
    """``world`` spawned ranks, one process each, joined by gloo over a
    ``FileStore``; metric state on ``device``. Each rank feeds its share
    (batch ``i`` to rank ``i % world``) of the ``sync`` phase's stream to
    that phase's collection plus exact ``BinaryAUROC``/``BinaryAUPRC``,
    then syncs over a ``MultiHostGroup``. Every rank's synced values and
    state must equal one process's stream bitwise (the loss mean within
    1e-6); a subgroup of rank 1 must leave rank 0 untouched."""
    cuda = torch.device(device).type == "cuda"
    sizes = {"classify_n": classify_n, "num_classes": num_classes, "batch": batch,
             "ctr_n": ctr_n, "ctr_batch": ctr_batch}
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        _spawn_ranks(_mp_rank, world, (str(device), out_dir, sizes, seed), timeout)
        spawn_seconds = time.perf_counter() - t0
        ranks = []
        for r in range(world):
            path = os.path.join(out_dir, f"rank{r}.pt")
            _check(os.path.exists(path), f"rank {r} wrote no result")
            ranks.append(torch.load(path, weights_only=False))

    # one process: the stream in order, and in the merged order (rank 0's
    # batches, then rank 1's, ...) that the synced buffers hold
    single = _sync_collection(device, num_classes, exact=True)
    _feed_sync_stream(lambda i: (single,), device, seed, classify_n, num_classes, batch,
                      ctr_n, ctr_batch)
    expected = {name: m.compute() for name, m in single.items()}
    merged_order = {k: _sync_collection(device, num_classes, exact=True)[k]
                    for k in ("exact_auroc", "exact_auprc")}
    for owner in range(world):
        _feed_sync_stream(lambda i: (merged_order,) if i % world == owner else (), device,
                          seed, classify_n, num_classes, batch, ctr_n, ctr_batch)
    states = _cpu_states({name: m.state_dict() for name, m in single.items()})
    states.update(_cpu_states({k: m.state_dict() for k, m in merged_order.items()}))
    loss_err = 0.0
    for r, got in enumerate(ranks):
        for name, value in got["values"].items():
            want = expected[name].cpu()
            if name == "loss":
                loss_err = max(loss_err, float((value - want).abs()))
            else:
                _check(torch.equal(value, want), f"rank {r}: synced {name} != single stream")
            for k, v in got["state_dicts"][name].items():
                _check(name == "loss" or _same_state(v, states[name][k]),
                       f"rank {r}: synced state {name}.{k} != single stream")
        _check(got["sub_member"] == (r == 1), f"rank {r}: subgroup membership wrong")
        _check(got["sub_untouched"], f"rank {r}: subgroup [1] sync touched its metrics")
        if cuda:
            _check(got["launches"] == 2 * got["clicks"],
                   f"rank {r}: K1 launched {got['launches']} times for {got['clicks']} click batches")
    _check(loss_err <= 1e-6 * max(1.0, float(expected["loss"].abs())), f"loss off by {loss_err}")
    seconds = [sorted(got["seconds"])[1] for got in ranks]
    return {
        "phase": "mp_sync", "device": str(device), "world": world, "backend": "gloo",
        "classify_samples": classify_n, "ctr_samples": ctr_n,
        "values": {k: float(v) for k, v in ranks[0]["values"].items()},
        "bitwise": sorted(k for k in expected if k != "loss"), "loss_abs_err": loss_err,
        "sync_seconds": seconds, "sync_seconds_runs": [got["seconds"] for got in ranks],
        "k1_launches": [got["launches"] for got in ranks], "spawn_seconds": spawn_seconds,
    }


def _time_ms(fn, device, reps):
    for _ in range(3):
        fn()
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(stop) / reps


def _host_ms(fn, device, reps):
    """Host time per call with no synchronize in the loop: what enqueuing
    one call costs the CPU (validation, ctypes call, launch)."""
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize(device)
    return seconds * 1e3 / reps


def _device_ms(fn, device, reps, kernel_name="fused_auc_hist_kernel"):
    """Device time per launch of the kernels named ``kernel_name`` from a
    torch.profiler (CUPTI) trace. A trace that shows none is taken once
    more (CUPTI has dropped a short window's kernels once in a sweep of
    hundreds); a second empty trace fails."""
    from torch.profiler import ProfilerActivity, profile

    seen = []
    for _ in range(2):
        torch.cuda.synchronize(device)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize(device)
        total_us, count = 0.0, 0
        for evt in prof.key_averages():
            if kernel_name in evt.key:
                total_us += getattr(evt, "device_time_total", 0.0) or getattr(evt, "cuda_time_total", 0.0)
                count += evt.count
        if count > 0 and total_us > 0:
            return total_us / 1e3 / count
        seen = [(e.key[:60], e.count) for e in prof.key_averages()][:12]
    raise AssertionError(f"profiler shows no device time for {kernel_name}; it saw {seen}")


def _bare_launch(out, s, y, w, num_bins, bounds, device):
    """The C launch alone, its arguments built once: what one launch costs
    the host below the wrapper (ctypes call, cudaLaunchKernelEx). Not
    counted in ``_kernels.LAUNCHES``: it is no wrapper launch."""
    lib = _kernels.load("fused_auc_hist")
    tasks, n = s.shape
    g = fa._geometry(lib, torch.cuda.current_device(), n, tasks, num_bins)
    args = fa._pack_launch(out, s, y, w, num_bins, bounds, g)
    stream = torch.cuda.current_stream(device).cuda_stream

    def launch():
        code = lib.tev_fused_auc_hist(args, stream)
        if code:
            _kernels.check(lib, code, "bare fused_auc_hist launch")
    return launch


def _timing_row(gen, n, tasks, skewed, weighted, device, num_bins=NUM_BINS):
    s = _scores(gen, (tasks, n), skewed, device)
    y = (torch.rand((tasks, n), generator=gen, device=device) < s).to(torch.float32)
    w = torch.rand((tasks, n), generator=gen, device=device) if weighted else None
    hist = torch.zeros((tasks, 2, num_bins), dtype=torch.float32, device=device)
    bins = torch.clamp((s * num_bins).to(torch.int64), max=num_bins - 1)
    bins = (bins + torch.arange(tasks, device=device)[:, None] * num_bins).reshape(-1)
    idx2 = torch.cat([bins, bins + tasks * num_bins])
    ww = torch.ones_like(s) if w is None else w
    w2 = torch.cat([(ww * y).reshape(-1), (ww * (1.0 - y)).reshape(-1)])
    reps = 200 if n <= CTR_BATCH else 20
    bounds = (0.0, 1.0)

    def launch():
        _histogram_cuda(hist, s, y, w, num_bins, bounds)

    metric = StreamingBinaryAUROC(num_tasks=tasks, num_bins=num_bins, device=device)
    us, uy, uw = (s[0], y[0], None) if tasks == 1 else (s, y, w)

    before = _kernels.LAUNCHES["fused_auc_hist"]
    kernel_ms = _time_ms(launch, device, reps)
    _check(_kernels.LAUNCHES["fused_auc_hist"] == before + reps + 3, "timing launch count")
    host = {
        "update": _host_ms(lambda: metric.update(us, uy, uw), device, reps),
        "wrapper": _host_ms(launch, device, reps),
        "c_launch": _host_ms(_bare_launch(hist, s, y, w, num_bins, bounds, device), device, reps),
    }
    device_ms = _device_ms(launch, device, reps)
    plain_ms = _time_ms(lambda: hist.add_(_histogram_plain_full(s, y, w, num_bins, bounds)),
                        device, reps)
    library_ms = _time_ms(
        lambda: torch.bincount(idx2, weights=w2, minlength=2 * tasks * num_bins), device, reps)
    # scores + labels (+ weights) read once, unit weights implicit; the
    # histogram read and written once (accumulate form)
    nbytes = (12 if weighted else 8) * tasks * n + 2 * 8 * tasks * num_bins
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {
        "n": n, "tasks": tasks, "num_bins": num_bins,
        "scores": "skewed" if skewed else "uniform", "weighted": weighted,
        "design": _k1_design(n, tasks, num_bins),
        "kernel_ms": kernel_ms, "kernel_device_ms": device_ms,
        "kernel_host_ms_per_call": host["wrapper"], "host_ms_per_call": host,
        "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bound_ms, "bound_by": "bytes", "bytes": nbytes,
        "bound_share_device": bound_ms / device_ms, "bound_share_events": bound_ms / kernel_ms,
        "reps": reps,
    }


def _design_name(g):
    """``rep_cCxK`` (replicated), ``split_cCxK``: K clusters of C CTAs a
    task; ``global_xK``: K blocks of the global-memory variant."""
    if not g.shared:
        return f"global_x{g.clusters_per_task}"
    return f"{'split' if g.split else 'rep'}_c{g.cluster}x{g.clusters_per_task}"


def _design_sweep(gen, device, full=False):
    """Device time of launch designs over batch sizes (T = 1, unit
    weights): at 8,192 bins, replicated clusters of 1 to 16 CTAs in counts
    from one a task to a full card, and the split layout; at 65,536 bins,
    the split layout against the global-memory variant. Sets the
    geometry's switch points. Forced geometries go through the checked
    wrapper like any other launch; the wrapper's own pick is timed first
    and marked ``picked``. ``full`` sweeps every batch size and design;
    the default keeps, at the smallest and largest batch, the designs on
    each side of the wrapper's switch points."""
    lib = _kernels.load("fused_auc_hist")
    dev = torch.cuda.current_device()
    active = fa._device_occupancy(lib, dev)
    rows = []

    def run(n, num_bins, skewed, designs):
        s = _scores(gen, (1, n), skewed, device)
        y = (torch.rand((1, n), generator=gen, device=device) < s).to(torch.float32)
        hist = torch.zeros((1, 2, num_bins), dtype=torch.float32, device=device)
        pick = fa._geometry(lib, dev, n, 1, num_bins)
        for g in [pick] + [g for g in designs if g != pick]:
            ms = _device_ms(lambda: _histogram_cuda(hist, s, y, None, num_bins, (0.0, 1.0), g),
                            device, 30 if n <= (1 << 20) else 10)
            rows.append({"n": n, "num_bins": num_bins, "scores": "skewed" if skewed else "uniform",
                         "design": _design_name(g), "picked": g == pick, "cluster": g.cluster,
                         "split": g.split, "clusters_per_task": g.clusters_per_task,
                         "device_ms": ms})

    sizes = (1 << 16, 1 << 18, 1 << 20, 1 << 24) if full else (1 << 16, 1 << 24)
    for n in sizes:
        designs = []
        for c in (1, 2, 4, 8, 16):
            most = active(c, 8 * NUM_BINS)
            for ctas in (8, 16, 32, 64, 128, c * most):
                k = ctas // c
                if 1 <= k <= most and (k == 1 or 4 * c * k * fa._THREADS <= n):
                    if full or ctas in (32, c * most):
                        designs.append(K1Geometry(c, k, 8 * NUM_BINS))
        split_most = active(8, NUM_BINS)
        designs += [K1Geometry(8, 1, NUM_BINS, True), K1Geometry(8, split_most, NUM_BINS, True)]
        for skewed in (True, False) if n == 1 << 24 else (True,):
            run(n, NUM_BINS, skewed, designs)
    big = 65_536
    for n in (1 << 16, 1 << 20, 1 << 24) if full else (1 << 16, 1 << 24):
        designs = []
        for c in (8, 16) if full else (8,):
            smem = 8 * big // c
            most = active(c, smem)
            designs += [K1Geometry(c, most, smem, True)]
            if full:
                designs += [K1Geometry(c, 1, smem, True)]
        most = active(1, 0)
        designs += [K1Geometry(1, k, 0) for k in ((4, 16, most) if full else (most,))]
        run(n, big, True, designs)
    return rows


def _design_choices(sweep):
    """For each swept shape: the wrapper's pick and the fastest design it
    passed over, with their device times."""
    out = []
    for key in dict.fromkeys((r["n"], r["num_bins"], r["scores"]) for r in sweep):
        group = [r for r in sweep if (r["n"], r["num_bins"], r["scores"]) == key]
        pick = next(r for r in group if r["picked"])
        other = min((r for r in group if not r["picked"]), key=lambda r: r["device_ms"])
        out.append({"n": key[0], "num_bins": key[1], "scores": key[2],
                    "pick": pick["design"], "pick_ms": pick["device_ms"],
                    "best_other": other["design"], "best_other_ms": other["device_ms"]})
    return out


def phase_timing(device, seed=4, full_sweep=False):
    gen = torch.Generator(device=device).manual_seed(seed)
    rows = []
    for n, tasks, skewed, weighted in (
        (CTR_BATCH, 1, False, False),
        (CTR_BATCH, 1, True, False),
        (CTR_BATCH, 4, True, True),  # the weighted multi-task stream's shape
        (1 << 24, 1, False, False),
        (1 << 24, 1, True, False),
    ):
        rows.append(_timing_row(gen, n, tasks, skewed, weighted, device))
    # 65,536 bins: the global-memory variant below 16 samples a bin, the
    # split layout above
    for n in (CTR_BATCH, 1 << 24):
        rows.append(_timing_row(gen, n, 1, True, False, device, num_bins=65_536))
    sweep = _design_sweep(gen, device, full_sweep)
    return {"phase": "timing", "card": _card_line(), "rows": rows,
            "design_choices": _design_choices(sweep), "design_sweep": sweep,
            "library_call": "torch.bincount over precomputed bin indices (binning not timed)"}


# ------------------------------------------------------------------ main


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def _ptxas_summary(log: str):
    """Registers, spills and barriers of each kernel in an ``-Xptxas -v``
    log, by mangled name."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            out[name] = []
        elif name and ("registers" in line or "spill" in line):
            out[name].append(line.strip())
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--sweep", action="store_true",
                        help="time every launch design over every batch size in the timing phase")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    built = _kernels.build_all()
    _emit({"phase": "build", "built": built, "seconds": time.perf_counter() - t0,
           "ptxas": _ptxas_summary(_kernels.build_log("fused_auc_hist"))})

    _kernels.reset_launch_counts()
    _emit(phase_classify(device, seed=args.seed))
    _check(_kernels.LAUNCHES["fused_auc_hist"] == 0, "classify launched K1")
    ctr = phase_ctr_auc(device, seed=args.seed + 1)
    _emit(ctr)
    kvp = phase_kernel_vs_plain(device, seed=args.seed + 2)
    _emit(kvp)
    _emit(phase_sync(device, seed=args.seed + 3))
    curve = phase_curve(device, seed=args.seed + 5)
    _emit(curve)
    _emit(phase_mp_sync(device, seed=args.seed + 6))
    timing = phase_timing(device, seed=args.seed + 4, full_sweep=args.sweep)
    _emit(timing)

    rows = [r for r in timing["rows"] if r["num_bins"] == NUM_BINS]
    main_row = next(r for r in rows
                    if r["n"] == CTR_BATCH and r["tasks"] == 1 and r["scores"] == "skewed")
    big = [r for r in rows if r["n"] == 1 << 24]
    _emit({"kernels": [{
        "name": "fused_auc_hist",
        "route": "cuda",
        "source": "torcheval_tpu_torch/ops/csrc/fused_auc_hist.cu",
        "replaces": "torcheval_tpu/ops/fused_auc.py:164",
        "launches": ctr["k1_launches"],
        "launches_use_fused": curve["k1_launches"],
        "max_abs_err": kvp["max_abs_err"],
        "ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": "bytes",
        "library_ms": main_row["library_ms"],
        "device_ms": main_row["kernel_device_ms"],
        "design": main_row["design"],
        "design_2_24": big[0]["design"],
        "bound_share_2_24": {r["scores"]: r["bound_share_device"] for r in big},
        "design_choices": [
            [c["n"], c["num_bins"], c["scores"], c["pick"], c["pick_ms"],
             c["best_other"], c["best_other_ms"]] for c in timing["design_choices"]],
    }]})
    print(_card_line(), flush=True)
    _emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
