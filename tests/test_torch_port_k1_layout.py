"""The fused-AUC kernel's launch geometry and its cluster-shared histogram
layout, on the CPU.

``k1_geometry`` is pure Python: it is tested here with the card's
occupancy passed in as a model of an H100 (132 SMs, 2,048 threads and
228 KB of shared memory an SM). The kernel itself runs only on the card;
what it does with a geometry -- bin b in CTA b % C at slot b // C, a
scalar head to the first 16-byte boundary, float4 groups, a scalar tail,
then each CTA flushing a contiguous range of the task's 2 * num_bins
entries read from their owners -- is mirrored in numpy and must rebuild
the plain histogram (and the JAX package's) bin for bin."""

from __future__ import annotations

import ctypes
import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from torcheval_tpu.ops.fused_auc import _histogram_xla
from torcheval_tpu_torch.ops import _kernels
from torcheval_tpu_torch.ops.fused_auc import K1Geometry, _histogram_plain, k1_geometry

fa = importlib.import_module("torcheval_tpu_torch.ops.fused_auc")  # ops.fused_auc is the function

CU = Path(fa.__file__).resolve().parent / "csrc" / "fused_auc_hist.cu"
SMS = 132
SMEM_PER_SM = 228 * 1024


def h100_model(cluster: int, smem_bytes: int) -> int:
    """Resident clusters on a model H100: CTAs an SM limited by threads
    and shared memory (1 KB reserved a CTA); the global variant (1, 0)
    gets every block slot of the card."""
    per_sm = 2048 // fa._THREADS
    if smem_bytes:
        per_sm = min(per_sm, SMEM_PER_SM // (smem_bytes + 1024))
    return SMS * per_sm // cluster


NUM_BINS = [2, 7, 512, 1000, 8192, 65536, 1 << 20]
SIZES = [1, 4097, 65_536, 1 << 24]


def _slots(num_bins, cluster):
    return -(-num_bins // cluster)


@pytest.mark.parametrize("num_bins", NUM_BINS)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("tasks", [1, 4])
def test_geometry_invariants(num_bins, n, tasks):
    g = k1_geometry(n, tasks, num_bins, active_clusters=h100_model)
    resident = h100_model(g.cluster, g.smem_bytes)
    if 8 * num_bins <= fa._REPLICA_MAX_BYTES:
        # replicated: every CTA of a cluster of 8 holds the whole histogram
        assert (g.cluster, g.smem_bytes, g.split, g.slots) == (8, 8 * num_bins, False, num_bins)
        per = 8 * fa._CTA_SAMPLES
    elif n >= fa._SPLIT_SAMPLES_PER_BIN * num_bins and 8 * _slots(num_bins, 16) <= fa._SLICE_MAX_BYTES:
        # split: bin b in CTA b % C, the smallest C whose slice fits the target
        assert g.split and g.cluster in (2, 4, 8, 16)
        assert g.slots == _slots(num_bins, g.cluster) and g.smem_bytes == 8 * g.slots
        assert g.smem_bytes <= fa._SLICE_TARGET_BYTES or g.cluster == 16
        assert g.cluster == 2 or 8 * _slots(num_bins, g.cluster // 2) > fa._SLICE_TARGET_BYTES
        per = g.cluster * fa._CTA_SAMPLES
    else:
        assert (g.cluster, g.smem_bytes, g.split, g.shared) == (1, 0, False, False)
        per = fa._GLOBAL_BLOCK_SAMPLES
    assert g.clusters_per_task == max(1, min(-(-n // per), resident // tasks))
    assert g.shared == (g.smem_bytes > 0)


@pytest.mark.parametrize(
    "n, tasks, num_bins, expected",
    [
        # the streaming metric's batch: 4 clusters of 8 CTAs, 2,048 samples each
        (65_536, 1, 8192, K1Geometry(8, 4, 65536)),
        (65_536, 4, 8192, K1Geometry(8, 4, 65536)),
        # a small batch: one cluster
        (16_384, 1, 8192, K1Geometry(8, 1, 65536)),
        # a large batch fills the card, the tasks sharing it
        (1 << 24, 1, 8192, K1Geometry(8, h100_model(8, 65536), 65536)),
        (1 << 24, 4, 8192, K1Geometry(8, h100_model(8, 65536) // 4, 65536)),
        # fewer bins than CTAs, and a bin count no multiple of the cluster
        (1, 1, 2, K1Geometry(8, 1, 16)),
        (4097, 1, 7, K1Geometry(8, 1, 56)),
        (4097, 1, 1000, K1Geometry(8, 1, 8000)),
        # 65,536 bins: split over 8 CTAs (64 KB slices) once the batch has
        # 16 samples a bin, else the global-memory variant
        (1 << 20, 1, 65536, K1Geometry(8, h100_model(8, 65536), 65536, True)),
        (65_536, 1, 65536, K1Geometry(1, 256, 0)),
        (1 << 24, 1, 131072, K1Geometry(16, h100_model(16, 65536), 65536, True)),
        # past the cluster's budget: the global-memory variant
        (1 << 24, 1, 1 << 20, K1Geometry(1, h100_model(1, 0), 0)),
    ],
)
def test_geometry_picks(n, tasks, num_bins, expected):
    assert k1_geometry(n, tasks, num_bins, active_clusters=h100_model) == expected


def test_geometry_more_tasks_than_clusters():
    # more tasks than resident clusters: one cluster each, in waves
    assert k1_geometry(1 << 24, 1000, 8192, active_clusters=h100_model).clusters_per_task == 1


def test_geometry_refuses():
    with pytest.raises(ValueError, match="num_bins"):
        k1_geometry(10, 1, 1, active_clusters=h100_model)
    with pytest.raises(ValueError, match="tasks"):
        k1_geometry(10, 65_536, 8, active_clusters=h100_model)
    # an unschedulable cluster raises: no other design is tried
    with pytest.raises(RuntimeError, match="can be scheduled"):
        k1_geometry(10, 1, 8192, active_clusters=lambda c, smem: 0)


# ------------------------------------------------------- the kernel mirrored


def _visits(n, offset, nthreads, unroll=2):
    """Sample indices each thread of a task visits, in the kernel's order:
    head up to the first 16-byte boundary of a row that starts ``offset``
    elements past one, then the tail, then float4 groups ``unroll`` at a
    time in a grid-stride loop."""
    head = min((4 - offset % 4) % 4, n)
    groups = (n - head) // 4
    tail = head + 4 * groups
    out = []
    for tid in range(nthreads):
        idx = list(range(tid, head, nthreads)) + list(range(tail + tid, n, nthreads))
        for g0 in range(tid, groups, unroll * nthreads):
            for u in range(unroll):
                g = g0 + u * nthreads
                if g < groups:
                    idx.extend(range(head + 4 * g, head + 4 * g + 4))
        out.append(idx)
    return out


def _mirror(bins, wpos, wneg, geometry, num_bins, out, nthreads_per_cta=4, offset=0):
    """One task through the kernel's layout: every cluster scatters its
    samples into its CTAs' shared memory (the visiting CTA's own copy when
    replicated, the owner's slice when split), then each CTA flushes its
    contiguous range of ``out`` (2 * num_bins), reading the owner's slot or
    summing the copies in rank order, and adding it in (a global atomic on
    the card; integer counts come out the same in any order)."""
    c, k, slots = geometry.cluster, geometry.clusters_per_task, geometry.slots
    n = bins.shape[0]
    visits = _visits(n, offset, c * k * nthreads_per_cta)
    seen = np.zeros(n, dtype=np.int64)
    for cl in range(k):
        smem = np.zeros((c, 2 * slots), dtype=np.float32)
        for cta in range(c):
            for th in range(nthreads_per_cta):
                for i in visits[(cl * c + cta) * nthreads_per_cta + th]:
                    seen[i] += 1
                    b = bins[i]
                    owner, slot = (b % c, b // c) if geometry.split else (cta, b)
                    if wpos[i] != 0:
                        smem[owner, slot] += wpos[i]
                    if wneg[i] != 0:
                        smem[owner, slots + slot] += wneg[i]
        entries = 2 * num_bins
        chunk = -(-entries // c)
        for rank in range(c):
            for j in range(rank * chunk, min((rank + 1) * chunk, entries)):
                if geometry.split:
                    row, b = divmod(j, num_bins)
                    v = smem[b % c, row * slots + b // c]
                else:
                    v = np.float32(0)
                    for q in range(c):
                        v = np.float32(v + smem[q, j])
                if v != 0:
                    out[j] += v
    assert (seen == 1).all(), "every sample visited exactly once"
    return out


@pytest.mark.parametrize("num_bins", [2, 7, 512, 1000, 8192])
@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("clusters", [1, 3])
@pytest.mark.parametrize("n, offset", [(1, 0), (3, 1), (4097, 0), (4097, 3), (20_000, 1)])
def test_cluster_layouts_rebuild_the_plain_histogram(num_bins, split, clusters, n, offset):
    rng = np.random.default_rng(num_bins * 7 + n + offset)
    # skewed CTR-like scores: a narrow band of low bins takes most samples
    s = (1.0 / (1.0 + np.exp(-(rng.standard_normal(n) * 1.5 - 3.5)))).astype(np.float32)
    y = (rng.random(n) < s).astype(np.float32)
    c = 8
    slots = _slots(num_bins, c) if split else num_bins
    g = K1Geometry(c, clusters, 8 * slots, split)
    assert (g.cluster * g.slots if split else g.slots) >= num_bins
    bins = np.minimum((s * np.float32(num_bins)).astype(np.int64), num_bins - 1)
    out = _mirror(bins, y, (1.0 - y).astype(np.float32), g, num_bins,
                  np.zeros(2 * num_bins, dtype=np.float32), offset=offset)
    plain = _histogram_plain(
        torch.from_numpy(s[None]), torch.from_numpy(y[None]), torch.ones(1, n), num_bins
    ).numpy()
    np.testing.assert_array_equal(out.reshape(2, num_bins), plain[0])
    ref = np.asarray(_histogram_xla(s[None], y[None], np.ones((1, n), np.float32), num_bins))
    np.testing.assert_array_equal(out.reshape(2, num_bins), ref[0])


@pytest.mark.parametrize("split", [False, True])
def test_flush_accumulates_into_the_state(split):
    """The flush adds into what the state already holds."""
    num_bins, n = 1000, 5000
    rng = np.random.default_rng(5)
    bins = rng.integers(0, num_bins, n)
    y = (rng.random(n) < 0.3).astype(np.float32)
    state = rng.integers(0, 50, 2 * num_bins).astype(np.float32)
    g = K1Geometry(8, 1, 8 * (_slots(num_bins, 8) if split else num_bins), split)
    got = _mirror(bins, y, 1.0 - y, g, num_bins, state.copy())
    want = state + np.concatenate([np.bincount(bins, y, num_bins), np.bincount(bins, 1 - y, num_bins)])
    np.testing.assert_array_equal(got, want.astype(np.float32))


# ------------------------------------------------- the binding and its source


def test_launch_struct_mirrors_the_source():
    """``_kernels.K1_LAUNCH_FIELDS`` and the source's ``K1Launch`` list the
    same fields in the same order with matching C types, and the packed
    size is the C struct's (8-byte aligned)."""
    body = re.search(r"struct K1Launch \{(.*?)\};", CU.read_text(), re.S).group(1)
    fields = re.findall(r"^\s*([\w\s\*]+?)\s*\b(\w+);", body, re.M)
    code_of = {"const float*": "P", "float*": "P", "long long": "q", "int": "i", "float": "f"}
    src = [(name, code_of[" ".join(t.split()).replace(" *", "*")]) for t, name in fields]
    assert list(_kernels.K1_LAUNCH_FIELDS) == src
    assert _kernels.K1_LAUNCH.size == 112 and _kernels.K1_LAUNCH.size % 8 == 0
    ctypes_size = ctypes.sizeof(type("S", (ctypes.Structure,), {"_fields_": [
        (name, {"P": ctypes.c_void_p, "q": ctypes.c_longlong, "i": ctypes.c_int,
                "f": ctypes.c_float}[code]) for name, code in src]}))
    assert _kernels.K1_LAUNCH.size == ctypes_size


@pytest.mark.parametrize("per_task", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_pack_launch_fills_every_field(per_task, weighted):
    """``_pack_launch`` (shared by the wrapper and the smoke's bare launch)
    puts each operand and geometry value in its own ``K1Launch`` field."""
    scores = torch.zeros((3, 10))
    labels = torch.zeros((1, 10)).expand(3, 10)  # broadcast: row stride 0
    weights = torch.zeros((3, 10)) if weighted else None
    out = torch.zeros((3, 2, 64))
    g = K1Geometry(8, 5, 512, False)
    task_bounds = (torch.zeros((3, 1)), torch.ones((3, 1))) if per_task else None
    bounds = None if per_task else (-3.0, 5.0)
    packed = fa._pack_launch(out, scores, labels, weights, 64, bounds, g, task_bounds)
    names = [name for name, _ in _kernels.K1_LAUNCH_FIELDS]
    got = dict(zip(names, _kernels.K1_LAUNCH.unpack(packed)))
    lo, inv_span = fa._fixed_bounds((-3.0, 5.0))
    assert got == {
        "scores": scores.data_ptr(), "labels": labels.data_ptr(),
        "weights": weights.data_ptr() if weighted else 0,
        "task_lo": task_bounds[0].data_ptr() if per_task else 0,
        "task_span": task_bounds[1].data_ptr() if per_task else 0,
        "out": out.data_ptr(), "label_row_stride": 0,
        "weight_row_stride": 10 if weighted else 0, "n": 10, "num_tasks": 3,
        "num_bins": 64, "per_task_bounds": int(per_task),
        "lo": 0.0 if per_task else float(lo), "inv_span": 0.0 if per_task else float(inv_span),
        "cluster": 8, "clusters_per_task": 5, "smem_bytes": 512, "split": 0,
    }


def test_python_constants_match_the_source():
    text = CU.read_text()
    assert int(re.search(r"constexpr int kThreads = (\d+);", text).group(1)) == fa._THREADS
    # a slice at C = 16 past the budget is the global variant's threshold
    assert 16 * fa._SLICE_MAX_BYTES // 8 == 204_800
    assert "num_bins > 204,800" in text


def test_checked_out_refuses_what_the_kernel_cannot_take():
    scores = torch.zeros((2, 10))
    fa._check_out(torch.zeros((2, 2, 8)), scores, 8)
    for bad in (
        torch.zeros((2, 2, 8), dtype=torch.float64),
        torch.zeros((1, 2, 8)),
        torch.zeros((2, 8, 2)).transpose(1, 2),
    ):
        with pytest.raises(ValueError, match="out must be"):
            fa._check_out(bad, scores, 8)
