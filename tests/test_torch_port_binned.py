"""torcheval_tpu_torch's binned curve family -- binned precision-recall
curves (both ``optimization`` modes), binned AUROC (buffered, and the
``HistogramBinnedAUROC`` histogram) and binned AUPRC -- against the JAX
package on the same numpy inputs, functional and class, plus a CPU run of
``chip_smoke.py``'s ``counters`` phase at small sizes.

Tolerances: per-threshold counters (float32, integer-valued) and the
int32 histogram are bitwise equal, and so are precision/recall curves
computed from them; AUROC and AUPRC agree within rtol 1e-6 (the trapezoid
and Riemann sums reduce in another order).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import torcheval_tpu.metrics as JM
import torcheval_tpu.metrics.functional as JF
from torcheval_tpu import distributed as jdist
from torcheval_tpu.metrics import toolkit as jtoolkit
import torcheval_tpu_torch.metrics as TM
import torcheval_tpu_torch.metrics.functional as TF
from torcheval_tpu_torch import distributed as tdist
from torcheval_tpu_torch.metrics import toolkit as ttoolkit
from torcheval_tpu_torch.metrics.functional.classification import binned_auroc as tbinned_auroc
from torcheval_tpu_torch.utils import load_numpy_state_dict, numpy_state_dict

CPU = "cpu"
RTOL = 1e-6
C = 6
GRIDS = [5, 11, [0.0, 0.1, 0.25, 0.25, 0.5, 0.9, 1.0]]
GRID_IDS = ["t5", "t11", "list"]


def _leaves(value):
    if isinstance(value, (list, tuple)):
        return [leaf for v in value for leaf in _leaves(v)]
    return [value.detach().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)]


def _bitwise(got, want):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes(), (g, w)


def _close(got, want):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-7)


def _scores(rng, shape, specials=True):
    """Scores in [0, 1] with values on the grid points (ties with a
    threshold), -0.0, and past both ends; NaN only where asked (the two
    ``optimization`` modes differ on NaN, in the JAX package too)."""
    s = rng.random(shape).astype(np.float32)
    flat = s.reshape(-1)
    flat[::7] = np.round(flat[::7] * 10) / 10
    flat[1::11] = 0.25
    if specials:
        flat[2::13] = -0.0
        flat[3::17] = -0.5
        flat[4::19] = 1.5
        flat[5::23] = 1.0
    return s


def _nan(s, every=29):
    s = s.copy()
    s.reshape(-1)[6::every] = np.nan
    return s


# ------------------------------------------------------------ functional PRC


@pytest.mark.parametrize("threshold", GRIDS, ids=GRID_IDS)
@pytest.mark.parametrize("nan", [False, True])
def test_binary_binned_prc_bitwise_equals_jax(threshold, nan):
    rng = np.random.default_rng(1)
    s = _scores(rng, 300)
    s = _nan(s) if nan else s
    t = (rng.random(300) < 0.4).astype(np.int64)
    got = TF.binary_binned_precision_recall_curve(s, t, threshold=threshold, device=CPU)
    _bitwise(got, JF.binary_binned_precision_recall_curve(s, t, threshold=threshold))


@pytest.mark.parametrize("optimization", ["vectorized", "memory"])
@pytest.mark.parametrize("threshold", GRIDS, ids=GRID_IDS)
@pytest.mark.parametrize("nan", [False, True])
def test_multiclass_binned_prc_bitwise_equals_jax(threshold, optimization, nan):
    rng = np.random.default_rng(2)
    s = _scores(rng, (200, C))
    s = _nan(s) if nan else s
    t = rng.integers(0, C, 200)
    t[:3] = [C, -1, C + 2]  # outside [0, C): no class
    kw = {"num_classes": C, "threshold": threshold, "optimization": optimization}
    got = TF.multiclass_binned_precision_recall_curve(s, t, device=CPU, **kw)
    _bitwise(got, JF.multiclass_binned_precision_recall_curve(s, t, **kw))


@pytest.mark.parametrize("optimization", ["vectorized", "memory"])
@pytest.mark.parametrize("threshold", GRIDS, ids=GRID_IDS)
@pytest.mark.parametrize("nan", [False, True])
def test_multilabel_binned_prc_bitwise_equals_jax(threshold, optimization, nan):
    rng = np.random.default_rng(3)
    s = _scores(rng, (150, C))
    s = _nan(s) if nan else s
    t = (rng.random((150, C)) < 0.35).astype(np.int64)
    kw = {"num_labels": C, "threshold": threshold, "optimization": optimization}
    got = TF.multilabel_binned_precision_recall_curve(s, t, device=CPU, **kw)
    _bitwise(got, JF.multilabel_binned_precision_recall_curve(s, t, **kw))


@pytest.mark.parametrize("family", ["multiclass", "multilabel"])
def test_the_two_optimization_modes_agree_without_nan(family):
    rng = np.random.default_rng(4)
    s = _scores(rng, (300, C))
    if family == "multiclass":
        t = rng.integers(0, C, 300)
        fn, kw = TF.multiclass_binned_precision_recall_curve, {"num_classes": C}
    else:
        t = (rng.random((300, C)) < 0.3).astype(np.int64)
        fn, kw = TF.multilabel_binned_precision_recall_curve, {"num_labels": C}
    vec = fn(s, t, threshold=17, optimization="vectorized", device=CPU, **kw)
    mem = fn(s, t, threshold=17, optimization="memory", device=CPU, **kw)
    _bitwise(vec, mem)


def test_optimization_check_matches_jax():
    for F, d in ((JF, {}), (TF, {"device": CPU})):
        with pytest.raises(ValueError, match="Unknown memory approach"):
            F.multiclass_binned_precision_recall_curve(
                np.zeros((2, 3), np.float32), np.zeros(2, np.int64), optimization="fast", **d)


# ------------------------------------------------------- functional AUC/AUPRC


@pytest.mark.parametrize("threshold", GRIDS + [200], ids=GRID_IDS + ["t200"])
@pytest.mark.parametrize("num_tasks", [1, 3])
def test_binary_binned_auroc_matches_jax(num_tasks, threshold):
    rng = np.random.default_rng(5)
    shape = (250,) if num_tasks == 1 else (num_tasks, 250)
    s = _nan(_scores(rng, shape))
    t = (rng.random(shape) < s).astype(np.int64)
    got = TF.binary_binned_auroc(s, t, num_tasks=num_tasks, threshold=threshold, device=CPU)
    _close(got, JF.binary_binned_auroc(s, t, num_tasks=num_tasks, threshold=threshold))


@pytest.mark.parametrize("average", ["macro", None])
@pytest.mark.parametrize("threshold", GRIDS, ids=GRID_IDS)
def test_multiclass_binned_auroc_matches_jax(threshold, average):
    rng = np.random.default_rng(6)
    s = _nan(_scores(rng, (220, C)))
    t = rng.integers(0, C, 220)
    kw = {"num_classes": C, "threshold": threshold, "average": average}
    _close(TF.multiclass_binned_auroc(s, t, device=CPU, **kw), JF.multiclass_binned_auroc(s, t, **kw))


def test_dense_compute_in_threshold_chunks_equals_one_compare(monkeypatch):
    rng = np.random.default_rng(7)
    s = torch.from_numpy(_scores(rng, (180, C)))
    t = torch.from_numpy(rng.integers(0, C, 180))
    bs = torch.from_numpy(_scores(rng, (2, 180)))
    bt = torch.from_numpy((rng.random((2, 180)) < 0.5).astype(np.float32))
    thr = torch.linspace(0, 1, 23)
    whole = (tbinned_auroc._multiclass_binned_auroc_compute_jit(s, t, thr),
             tbinned_auroc._binary_binned_auroc_compute_jit(bs, bt, thr))
    monkeypatch.setattr(tbinned_auroc, "_COMPARE_CHUNK", 5 * s.numel())  # 5 thresholds a chunk
    chunked = (tbinned_auroc._multiclass_binned_auroc_compute_jit(s, t, thr),
               tbinned_auroc._binary_binned_auroc_compute_jit(bs, bt, thr))
    _bitwise(chunked, whole)


@pytest.mark.parametrize("threshold", [5, 11, [0.0, 0.3, 0.3, 0.8, 1.0]], ids=GRID_IDS)
@pytest.mark.parametrize("num_tasks", [1, 2])
def test_binary_binned_auprc_matches_jax(num_tasks, threshold):
    rng = np.random.default_rng(8)
    shape = (260,) if num_tasks == 1 else (num_tasks, 260)
    s = _nan(_scores(rng, shape))
    t = (rng.random(shape) < s).astype(np.int64)
    got = TF.binary_binned_auprc(s, t, num_tasks=num_tasks, threshold=threshold, device=CPU)
    _close(got, JF.binary_binned_auprc(s, t, num_tasks=num_tasks, threshold=threshold))


@pytest.mark.parametrize("optimization", ["vectorized", "memory"])
@pytest.mark.parametrize("average", ["macro", None, "none"])
@pytest.mark.parametrize("family", ["multiclass", "multilabel"])
def test_multi_binned_auprc_matches_jax(family, average, optimization):
    rng = np.random.default_rng(9)
    s = _scores(rng, (240, C))
    if family == "multiclass":
        t = rng.integers(0, C, 240)
        kw = {"num_classes": C}
    else:
        t = (rng.random((240, C)) < 0.3).astype(np.int64)
        kw = {"num_labels": C}
    kw.update(threshold=9, average=average, optimization=optimization)
    name = f"{family}_binned_auprc"
    _close(getattr(TF, name)(s, t, device=CPU, **kw), getattr(JF, name)(s, t, **kw))


@pytest.mark.parametrize("threshold", [[0.1, 0.5, 1.0], [0.0, 0.5], 1])
def test_auprc_grids_must_span_zero_to_one_like_jax(threshold):
    s, t = np.float32([0.2, 0.7]), np.int64([0, 1])
    with pytest.raises(ValueError) as want:
        JF.binary_binned_auprc(s, t, threshold=threshold)
    with pytest.raises(ValueError) as got:
        TF.binary_binned_auprc(s, t, threshold=threshold, device=CPU)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------------ classes


def _binary_batches(seed, tasks=None):
    rng = np.random.default_rng(seed)
    out = []
    for n in (70, 45, 30):
        shape = (n,) if tasks is None else (tasks, n)
        s = _scores(rng, shape)
        out.append((s, (rng.random(shape) < s).astype(np.int64)))
    return out


def _multiclass_batches(seed):
    rng = np.random.default_rng(seed)
    return [(_scores(rng, (n, C)), rng.integers(0, C, n)) for n in (70, 45, 30)]


def _multilabel_batches(seed):
    rng = np.random.default_rng(seed)
    return [(_scores(rng, (n, C)), (rng.random((n, C)) < 0.3).astype(np.int64))
            for n in (70, 45, 30)]


CASES = {
    "binary_prc": (lambda P, **k: P.BinaryBinnedPrecisionRecallCurve(threshold=9, **k),
                   _binary_batches, "bitwise"),
    "multiclass_prc_vec": (lambda P, **k: P.MulticlassBinnedPrecisionRecallCurve(
        num_classes=C, threshold=GRIDS[2], **k), _multiclass_batches, "bitwise"),
    "multiclass_prc_mem": (lambda P, **k: P.MulticlassBinnedPrecisionRecallCurve(
        num_classes=C, threshold=8, optimization="memory", **k), _multiclass_batches, "bitwise"),
    "multilabel_prc_vec": (lambda P, **k: P.MultilabelBinnedPrecisionRecallCurve(
        num_labels=C, threshold=7, **k), _multilabel_batches, "bitwise"),
    "multilabel_prc_mem": (lambda P, **k: P.MultilabelBinnedPrecisionRecallCurve(
        num_labels=C, threshold=7, optimization="memory", **k), _multilabel_batches, "bitwise"),
    "binary_auprc": (lambda P, **k: P.BinaryBinnedAUPRC(threshold=10, **k), _binary_batches,
                     "close"),
    "binary_auprc_tasks": (lambda P, **k: P.BinaryBinnedAUPRC(num_tasks=3, threshold=6, **k),
                           lambda seed: _binary_batches(seed, tasks=3), "close"),
    "multiclass_auprc": (lambda P, **k: P.MulticlassBinnedAUPRC(num_classes=C, threshold=12, **k),
                         _multiclass_batches, "close"),
    "multiclass_auprc_mem": (lambda P, **k: P.MulticlassBinnedAUPRC(
        num_classes=C, threshold=5, average=None, optimization="memory", **k),
        _multiclass_batches, "close"),
    "multilabel_auprc": (lambda P, **k: P.MultilabelBinnedAUPRC(num_labels=C, threshold=5, **k),
                         _multilabel_batches, "close"),
    "multilabel_auprc_mem": (lambda P, **k: P.MultilabelBinnedAUPRC(
        num_labels=C, threshold=5, average=None, optimization="memory", **k),
        _multilabel_batches, "close"),
    "binary_auroc": (lambda P, **k: P.BinaryBinnedAUROC(threshold=13, **k), _binary_batches,
                     "close"),
    "binary_auroc_tasks": (lambda P, **k: P.BinaryBinnedAUROC(num_tasks=3, threshold=5, **k),
                           lambda seed: _binary_batches(seed, tasks=3), "close"),
    "multiclass_auroc": (lambda P, **k: P.MulticlassBinnedAUROC(num_classes=C, threshold=9, **k),
                         _multiclass_batches, "close"),
    "multiclass_auroc_none": (lambda P, **k: P.MulticlassBinnedAUROC(
        num_classes=C, threshold=GRIDS[2], average=None, **k), _multiclass_batches, "close"),
    "hist_auroc": (lambda P, **k: P.HistogramBinnedAUROC(threshold=50, **k), _binary_batches,
                   "close"),
    "hist_auroc_list": (lambda P, **k: P.HistogramBinnedAUROC(threshold=GRIDS[2], **k),
                        _binary_batches, "close"),
}
NAMES = sorted(CASES)


def _feed(metric, batches):
    for x, y in batches:
        metric.update(x, y)
    return metric


def _assert_states(tm, jm):
    jsd = jm.state_dict()
    assert sorted(tm.state_dict()) == sorted(jsd)
    for name, value in jsd.items():
        ours = getattr(tm, name)
        if isinstance(value, int):
            assert ours == value
            continue
        ours, theirs = ours.numpy(), np.asarray(value)
        assert ours.dtype == theirs.dtype and ours.shape == theirs.shape, name
        assert ours.tobytes() == theirs.tobytes(), name


def _check_values(name, got, want):
    (_bitwise if CASES[name][2] == "bitwise" else _close)(got, want)


@pytest.mark.parametrize("name", NAMES)
def test_class_update_compute_reset_matches_jax(name):
    make, batches, _ = CASES[name]
    tm, jm = make(TM, device=CPU), make(JM)
    _assert_states(tm, jm)
    _feed(tm, batches(10))
    _feed(jm, batches(10))
    _assert_states(tm, jm)
    _check_values(name, tm.compute(), jm.compute())
    _check_values(name, tm.compute(), jm.compute())
    tm.reset()
    jm.reset()
    _assert_states(tm, jm)
    _feed(tm, batches(11)[:1])
    _feed(jm, batches(11)[:1])
    _check_values(name, tm.compute(), jm.compute())


@pytest.mark.parametrize("name", NAMES)
def test_class_merge_state_matches_jax(name):
    make, batches, _ = CASES[name]
    stream = batches(20)
    tms = [_feed(make(TM, device=CPU), [b]) for b in stream]
    jms = [_feed(make(JM), [b]) for b in stream]
    tms[0].merge_state(tms[1:])
    jms[0].merge_state(jms[1:])
    _assert_states(tms[0], jms[0])
    _check_values(name, tms[0].compute(), jms[0].compute())


def _to_jax(sd):
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in sd.items()}


@pytest.mark.parametrize("updated", [False, True], ids=["fresh", "updated"])
@pytest.mark.parametrize("name", NAMES)
def test_state_dict_cross_loads_both_ways(name, updated):
    make, batches, _ = CASES[name]
    jm = _feed(make(JM), batches(30) if updated else [])
    tm = make(TM, device=CPU)
    load_numpy_state_dict(tm, {k: np.asarray(v) if not isinstance(v, int) else v
                               for k, v in jm.state_dict().items()})
    _assert_states(tm, jm)
    back = make(JM)
    back.load_state_dict(_to_jax(numpy_state_dict(tm)))
    _assert_states(tm, back)
    more = batches(31)[:2]
    _feed(tm, more)
    _feed(back, more)
    _assert_states(tm, back)
    _check_values(name, tm.compute(), back.compute())


def test_local_replica_sync_of_binned_collection_equals_one_stream():
    names = ["binary_prc", "multiclass_prc_mem", "multilabel_auprc", "hist_auroc",
             "binary_auroc", "multiclass_auroc"]
    world = 3
    tgroup = tdist.LocalReplicaGroup([torch.device(CPU)] * world)
    jgroup = jdist.LocalReplicaGroup(jax.devices("cpu")[:world])
    treps = [{n: CASES[n][0](TM, device=CPU) for n in names} for _ in range(world)]
    jreps = [{n: CASES[n][0](JM) for n in names} for _ in range(world)]
    single = {n: CASES[n][0](TM, device=CPU) for n in names}
    for n in names:
        for r, batch in enumerate(CASES[n][1](40)):
            for coll in (treps[r], jreps[r], single):
                coll[n].update(*batch)
    tsynced = ttoolkit.get_synced_metric_collection(treps, tgroup)
    jsynced = jtoolkit.get_synced_metric_collection(jreps, jgroup)
    for n in names:
        _assert_states(tsynced[n], jsynced[n])
        _check_values(n, tsynced[n].compute(), jsynced[n].compute())
        _bitwise(tsynced[n].compute(), single[n].compute())


def test_histogram_auroc_equals_dense_counters_at_a_million_bins():
    """The histogram's suffix sums are the dense per-threshold counters:
    at 2^20 thresholds it matches the JAX class bitwise in state and
    within rtol 1e-6 in value."""
    rng = np.random.default_rng(12)
    s = _scores(rng, 5000)
    t = (rng.random(5000) < s).astype(np.int64)
    tm = TM.HistogramBinnedAUROC(threshold=1 << 20, device=CPU).update(s, t)
    jm = JM.HistogramBinnedAUROC(threshold=1 << 20).update(s, t)
    _assert_states(tm, jm)
    _close(tm.compute(), jm.compute())
    assert int(tm.hist.sum()) == int(((s >= 0) | np.isnan(s)).sum())


def test_histogram_auroc_shard_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="item A6"):
        TM.HistogramBinnedAUROC(threshold=4, device=CPU, shard=object())


def test_threshold_moves_with_the_metric():
    m = TM.MulticlassBinnedAUPRC(num_classes=3, threshold=4, device=CPU)
    assert m.to(CPU).threshold.device == torch.device(CPU)
    assert TM.MulticlassBinnedAUPRC._extra_device_attrs == ("threshold",)


@pytest.mark.parametrize("make", [
    lambda **k: TM.BinaryBinnedPrecisionRecallCurve(**k),
    lambda **k: TM.MulticlassBinnedAUPRC(num_classes=3, **k),
    lambda **k: TM.HistogramBinnedAUROC(**k),
    lambda **k: TM.BinaryBinnedAUROC(**k),
])
def test_binned_classes_default_to_cuda(make):
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


# ------------------------------------------------------- the chip phase, small


def test_phase_counters_small_on_cpu():
    out = chip_smoke.phase_counters(
        CPU, imagenet_n=1500, num_classes=40, batch=256, ctr_n=150_000, ctr_batch=40_000,
        ctr_buffered=1 << 15, hist_bins=(100, 1 << 14), openimages_n=900, num_labels=30,
        num_thresholds=100)
    assert out["phase"] == "counters"
    imagenet, criteo, openimages = out["imagenet"], out["criteo"], out["openimages"]
    assert imagenet["prc_modes_bitwise"]
    assert criteo["hist_bitwise"] == [True, True]
    assert max(criteo["hist_auroc_err_vs_float64"]) <= 1e-6
    assert openimages["topk_oracle_bitwise"]


# ------------------------------------------------------------ empty batches


@pytest.mark.parametrize("threshold", [5, 100], ids=["t5", "t100"])
def test_empty_batch_gives_zero_counters_like_jax(threshold):
    """An empty batch: all-zero counters, AUPRC 0, precision 1 and recall
    NaN over the threshold grid, as in the JAX package."""
    e = np.zeros(0, np.float32)
    _bitwise(TF.binary_binned_precision_recall_curve(e, e, threshold=threshold, device=CPU),
             JF.binary_binned_precision_recall_curve(e, e, threshold=threshold))
    _bitwise(TF.binary_binned_auprc(e, e, threshold=threshold, device=CPU),
             JF.binary_binned_auprc(e, e, threshold=threshold))
    assert float(TF.binary_binned_auprc(e, e, threshold=threshold, device=CPU)[0]) == 0.0
    e2 = np.zeros((2, 0), np.float32)
    _bitwise(TF.binary_binned_auprc(e2, e2, num_tasks=2, threshold=threshold, device=CPU),
             JF.binary_binned_auprc(e2, e2, num_tasks=2, threshold=threshold))


@pytest.mark.parametrize("name", ["prc", "auprc", "auprc_tasks"])
def test_empty_batch_mid_stream_passes_through_like_jax(name):
    """Class updates with an empty batch, first and in the middle of a
    stream, leave the counters as the JAX classes leave theirs."""
    rng = np.random.default_rng(31)
    tasks = 2 if name == "auprc_tasks" else 1
    shape = (tasks, 40) if tasks > 1 else (40,)
    empty = np.zeros((tasks, 0) if tasks > 1 else (0,), np.float32)
    make = {
        "prc": lambda P, **kw: P.BinaryBinnedPrecisionRecallCurve(threshold=7, **kw),
        "auprc": lambda P, **kw: P.BinaryBinnedAUPRC(threshold=7, **kw),
        "auprc_tasks": lambda P, **kw: P.BinaryBinnedAUPRC(num_tasks=2, threshold=7, **kw),
    }[name]
    tm, jm = make(TM, device=CPU), make(JM)
    batches = [(empty, empty)]
    for _ in range(2):
        s = _scores(rng, shape)
        batches += [(s, (rng.random(shape) < 0.4).astype(np.float32)), (empty, empty)]
    for x, y in batches:
        tm.update(x, y)
        jm.update(x, y)
        for state in tm._state_name_to_default:
            _bitwise(getattr(tm, state), np.asarray(getattr(jm, state)))
    _close(tm.compute(), jm.compute())  # the area: float sums in another order
