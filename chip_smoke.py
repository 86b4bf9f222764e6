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
   of 2^22 samples; the histograms are checked against a float64 oracle and
   the fused-AUC kernel must have launched once per update.
3. ``kernel_vs_plain``: the kernel wrapper against its plain PyTorch
   version on the same CUDA tensors, over sizes, task counts, score
   distributions, weights, bounds, NaN and empty inputs and bin counts:
   bitwise equal on unit weights, within rtol 1e-5 with mass conserved on
   random weights.
4. ``sync``: four ``LocalReplicaGroup`` replicas on the card, each fed a
   quarter of smaller classify and click streams; the synced results must
   equal single-stream metrics bitwise.
5. ``timing``: the kernel against its plain version and ``torch.bincount``
   at the main path's shapes, with the least time the memory traffic needs.

Then a ``{"kernels": [...]}`` line, the card's name and power limit as
``nvidia-smi`` reports them, and, last, ``{"ok": true, "device": {...}}``.
Any failure raises, and the script exits non-zero without that last line;
without a CUDA device it exits non-zero at once.

The phase functions take ``device`` and sizes, so the CPU tests run phases
1, 2 and 4 at small sizes with ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torcheval_tpu_torch.distributed import LocalReplicaGroup  # noqa: E402
from torcheval_tpu_torch.metrics import (  # noqa: E402
    Mean,
    MulticlassAccuracy,
    MulticlassF1Score,
    StreamingBinaryAUPRC,
    StreamingBinaryAUROC,
    Throughput,
)
from torcheval_tpu_torch.metrics import toolkit  # noqa: E402
from torcheval_tpu_torch.ops import _kernels  # noqa: E402
from torcheval_tpu_torch.ops.fused_auc import (  # noqa: E402
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


def _kernel_case(gen, n, tasks, skewed, weighted, bounds, num_bins, device, nan=False):
    """One kernel-vs-plain comparison on the same CUDA tensors.

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
    labels = (torch.rand((tasks, n), generator=gen, device=device) < base).to(torch.float32)
    weights = torch.rand((tasks, n), generator=gen, device=device) if weighted else None
    out = torch.zeros((tasks, 2, num_bins), dtype=torch.float32, device=device)
    before = _kernels.LAUNCHES["fused_auc_hist"]
    _histogram_cuda(out, raw.contiguous(), labels, weights, num_bins, bounds)
    plain = _histogram_plain_full(raw, labels, weights, num_bins, bounds)
    _sync(device)
    _check(
        _kernels.LAUNCHES["fused_auc_hist"] == before + (1 if n else 0),
        "wrapper launch count wrong",
    )
    abs_err = float((out - plain).abs().max()) if out.numel() else 0.0
    rel = plain_rel = mass = 0.0
    if weighted:
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
        "bounds": bounds, "num_bins": num_bins, "nan": nan,
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
    return {
        "phase": "kernel_vs_plain", "cases": len(cases),
        "bitwise_cases": sum(1 for c in cases if not c["weighted"]),
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "max_rel_err_vs_float64": max(c["max_rel_err_vs_float64"] for c in cases),
        "plain_max_rel_err_vs_float64": max(c["plain_max_rel_err_vs_float64"] for c in cases),
        "max_mass_rel_err": max(c["mass_rel_err"] for c in cases),
    }


def phase_sync(device, classify_n=8192, num_classes=1000, batch=1024,
               ctr_n=1 << 22, ctr_batch=CTR_BATCH, world=4, seed=3):
    group = LocalReplicaGroup([torch.device(device)] * world)

    def collection():
        return {
            "acc": MulticlassAccuracy(device=device),
            "acc_macro": MulticlassAccuracy(average="macro", num_classes=num_classes, device=device),
            "f1_macro": MulticlassF1Score(num_classes=num_classes, average="macro", device=device),
            "loss": Mean(device=device),
            "auroc": StreamingBinaryAUROC(device=device),
            "auprc": StreamingBinaryAUPRC(device=device),
        }

    single, replicas = collection(), [collection() for _ in range(world)]
    gen = torch.Generator(device=device).manual_seed(seed)
    cls_names = ("acc", "acc_macro", "f1_macro")
    for i, start in enumerate(range(0, classify_n, batch)):
        logits, labels = _classify_batch(gen, min(batch, classify_n - start), num_classes, device)
        batch_loss = F.cross_entropy(logits, labels)
        for coll in (single, replicas[i % world]):
            toolkit.update_collection({k: coll[k] for k in cls_names}, logits, labels)
            coll["loss"].update(batch_loss)
    for i, start in enumerate(range(0, ctr_n, ctr_batch)):
        s, y = _clicks(gen, (min(ctr_batch, ctr_n - start),), device)
        for coll in (single, replicas[i % world]):
            toolkit.update_collection({k: coll[k] for k in ("auroc", "auprc")}, s, y)
    t0 = time.perf_counter()
    synced = toolkit.get_synced_metric_collection(replicas, group)
    values = {name: m.compute() for name, m in synced.items()}
    _sync(device)
    seconds = time.perf_counter() - t0
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
        "loss_abs_err": loss_err, "sync_seconds": seconds,
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


def _device_ms(fn, device, reps, kernel_name):
    """Device time per launch of the kernels named ``kernel_name`` from a
    torch.profiler (CUPTI) trace; None when the trace shows none."""
    from torch.profiler import ProfilerActivity, profile

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
    return total_us / 1e3 / count if count else None


def phase_timing(device, seed=4):
    gen = torch.Generator(device=device).manual_seed(seed)
    rows = []
    for n in (CTR_BATCH, 1 << 24):
        for skewed in (False, True):
            s = _scores(gen, (1, n), skewed, device)
            y = (torch.rand((1, n), generator=gen, device=device) < s).to(torch.float32)
            hist = torch.zeros((1, 2, NUM_BINS), dtype=torch.float32, device=device)
            bins = torch.clamp((s * NUM_BINS).to(torch.int64), max=NUM_BINS - 1).reshape(-1)
            idx2 = torch.cat([bins, bins + NUM_BINS])
            w2 = torch.cat([y, 1.0 - y], dim=1).reshape(-1)
            reps = 200 if n <= CTR_BATCH else 20
            def launch():
                _histogram_cuda(hist, s, y, None, NUM_BINS, (0.0, 1.0))

            before = _kernels.LAUNCHES["fused_auc_hist"]
            kernel_ms = _time_ms(launch, device, reps)
            _check(_kernels.LAUNCHES["fused_auc_hist"] == before + reps + 3, "timing launch count")
            host_ms = _host_ms(launch, device, reps)
            device_ms = _device_ms(launch, device, reps, "fused_auc_hist_kernel")
            plain_ms = _time_ms(
                lambda: hist.add_(_histogram_plain_full(s, y, None, NUM_BINS, (0.0, 1.0))),
                device, reps)
            library_ms = _time_ms(
                lambda: torch.bincount(idx2, weights=w2, minlength=2 * NUM_BINS),
                device, reps)
            # scores + labels read once (unit weights are implicit); the
            # histogram read and written once (accumulate form)
            nbytes = 8 * n + 2 * 8 * NUM_BINS
            rows.append({
                "n": n, "tasks": 1, "num_bins": NUM_BINS,
                "scores": "skewed" if skewed else "uniform",
                "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "kernel_device_ms": device_ms, "kernel_host_ms_per_call": host_ms,
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                "bytes": nbytes, "reps": reps,
            })
    return {"phase": "timing", "card": _card_line(), "rows": rows,
            "library_call": "torch.bincount over precomputed bin indices (binning not timed)"}


# ------------------------------------------------------------------ main


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
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
           "ptxas": _kernels.build_log("fused_auc_hist").strip().splitlines()[-6:]})

    _kernels.reset_launch_counts()
    _emit(phase_classify(device, seed=args.seed))
    _check(_kernels.LAUNCHES["fused_auc_hist"] == 0, "classify launched K1")
    ctr = phase_ctr_auc(device, seed=args.seed + 1)
    _emit(ctr)
    kvp = phase_kernel_vs_plain(device, seed=args.seed + 2)
    _emit(kvp)
    _emit(phase_sync(device, seed=args.seed + 3))
    timing = phase_timing(device, seed=args.seed + 4)
    _emit(timing)

    main_row = next(r for r in timing["rows"] if r["n"] == CTR_BATCH and r["scores"] == "skewed")
    _emit({"kernels": [{
        "name": "fused_auc_hist",
        "route": "cuda",
        "source": "torcheval_tpu_torch/ops/csrc/fused_auc_hist.cu",
        "replaces": "torcheval_tpu/ops/fused_auc.py:164",
        "launches": ctr["k1_launches"],
        "max_abs_err": kvp["max_abs_err"],
        "ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": "bytes",
        "library_ms": main_row["library_ms"],
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
