"""torcheval_tpu_torch's ranking family -- click-through rate, weighted
calibration, hit rate, reciprocal rank, retrieval precision, frequency @
k and id collisions -- against the JAX package on the same numpy inputs:
functional forms over their edge cases, and the classes through update,
compute, reset, ``merge_state``, a ``state_dict`` cross-load both ways
(``RetrievalPrecision``'s per-query lists included) and a
``LocalReplicaGroup`` sync.

Tolerances: bitwise for hit rate, reciprocal rank, retrieval precision,
frequency, collisions (int32 included) and click-through rate over 0/1
clicks with unit or dyadic weights (every sum is exact); rtol 1e-6 for
float sums whose order differs between XLA and torch (weighted CTR,
calibration).
"""

from __future__ import annotations

import doctest
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as JM
import torcheval_tpu.metrics.functional as JF
from torcheval_tpu import distributed as jdist
from torcheval_tpu.metrics import toolkit as jtoolkit
import torcheval_tpu_torch.metrics as TM
import torcheval_tpu_torch.metrics.functional as TF
from torcheval_tpu_torch import distributed as tdist
from torcheval_tpu_torch.metrics import toolkit as ttoolkit
from torcheval_tpu_torch.utils import load_numpy_state_dict, numpy_state_dict

CPU = "cpu"
RTOL = 1e-6
C = 12  # classes a row


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _same(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, got.dtype,
                                                                  want.shape, want.dtype)
    assert got.tobytes() == want.tobytes(), (got, want)


def _close(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7, equal_nan=True)


# ---------------------------------------------------------- click-through


def _clicks(seed, shape, dtype=np.int64):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) < 0.3).astype(dtype)


@pytest.mark.parametrize("weights", [None, 1, 3, 0.5, 0, "dyadic", "random"])
@pytest.mark.parametrize("num_tasks", [1, 3])
def test_click_through_rate_matches_jax(num_tasks, weights):
    shape = (200,) if num_tasks == 1 else (num_tasks, 200)
    x = _clicks(num_tasks, shape)
    rng = np.random.default_rng(11)
    if weights == "dyadic":
        weights = (rng.integers(0, 8, shape) / 4).astype(np.float32)
    elif weights == "random":
        weights = rng.random(shape).astype(np.float32)
    got = TF.click_through_rate(x, weights, num_tasks=num_tasks, device=CPU)
    want = JF.click_through_rate(x, weights, num_tasks=num_tasks)
    if isinstance(weights, np.ndarray) and weights.dtype == np.float32 and (weights * 4 % 1).any():
        _close(got, want)  # random weights: float sums in another order
    else:
        _same(got, want)


@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.bool_])
def test_click_dtypes_match_jax(dtype):
    x = _clicks(3, (150,), dtype)
    for w in (1.0, 2):
        _same(TF.click_through_rate(x, w, device=CPU), JF.click_through_rate(x, w))


def test_zero_weight_reads_zero_not_nan():
    x = _clicks(4, (2, 10))
    w = np.ones((2, 10), np.float32)
    w[1] = 0.0
    got = TF.click_through_rate(x, w, num_tasks=2, device=CPU)
    _same(got, JF.click_through_rate(x, w, num_tasks=2))
    assert _np(got)[1] == 0.0


@pytest.mark.parametrize("call", [
    lambda F, **k: F.click_through_rate(np.zeros((2, 3, 4)), **k),
    lambda F, **k: F.click_through_rate(np.zeros(3), np.ones(4), **k),
    lambda F, **k: F.click_through_rate(np.zeros((2, 3)), **k),
    lambda F, **k: F.click_through_rate(np.zeros((3, 3)), num_tasks=2, **k),
    lambda F, **k: F.weighted_calibration(np.zeros(3), np.zeros(4), **k),
    lambda F, **k: F.weighted_calibration(np.zeros((2, 3)), np.zeros((2, 3)), **k),
    lambda F, **k: F.weighted_calibration(np.zeros(3), np.zeros(3), np.ones(2), **k),
    lambda F, **k: F.hit_rate(np.zeros((2, 3)), np.zeros((2, 1)), **k),
    lambda F, **k: F.hit_rate(np.zeros(3), np.zeros(3), **k),
    lambda F, **k: F.hit_rate(np.zeros((2, 3)), np.zeros(3), **k),
    lambda F, **k: F.hit_rate(np.zeros((2, 3)), np.zeros(2), k=0, **k),
    lambda F, **k: F.reciprocal_rank(np.zeros((2, 3)), np.zeros(3), **k),
    lambda F, **k: F.retrieval_precision(np.zeros(3), np.zeros(4), **k),
    lambda F, **k: F.retrieval_precision(np.zeros(3), np.zeros(3), k=0, **k),
    lambda F, **k: F.retrieval_precision(np.zeros(3), np.zeros(3), limit_k_to_size=True, **k),
    lambda F, **k: F.retrieval_precision(np.zeros((2, 3)), np.zeros((2, 3)), num_tasks=3, **k),
    lambda F, **k: F.frequency_at_k(np.zeros((2, 3)), 0.5, **k),
    lambda F, **k: F.frequency_at_k(np.zeros(3), -1.0, **k),
    lambda F, **k: F.num_collisions(np.zeros((2, 3), np.int32), **k),
    lambda F, **k: F.num_collisions(np.zeros(3, np.float32), **k),
])
def test_bad_arguments_raise_like_jax(call):
    with pytest.raises(ValueError) as theirs:
        call(JF)
    with pytest.raises(ValueError) as ours:
        call(TF, device=CPU)
    assert str(ours.value).split("(")[0].split("got")[0] == \
        str(theirs.value).split("(")[0].split("got")[0]


# ------------------------------------------------------------ calibration


@pytest.mark.parametrize("weight", [1.0, 2, "tensor"])
@pytest.mark.parametrize("num_tasks", [1, 3])
def test_weighted_calibration_matches_jax(num_tasks, weight):
    shape = (300,) if num_tasks == 1 else (num_tasks, 300)
    rng = np.random.default_rng(num_tasks)
    p = rng.random(shape).astype(np.float32)
    y = (rng.random(shape) < p).astype(np.int64)
    if weight == "tensor":
        weight = rng.random(shape).astype(np.float32)
    _close(TF.weighted_calibration(p, y, weight, num_tasks=num_tasks, device=CPU),
           JF.weighted_calibration(p, y, weight, num_tasks=num_tasks))


# --------------------------------------------------- hit rate, recip. rank


def _ranked(seed, n=48, dtype=np.float32):
    """Scores with a tied row, coarse ties, NaN scores, NaN at the target,
    +-0, and targets wrapped (in [-C, 0)) or out of range."""
    rng = np.random.default_rng(seed)
    x = rng.random((n, C)).astype(np.float32)
    t = rng.integers(0, C, n)
    x[0] = 0.5
    x[1, ::3] = np.nan
    x[2, t[2]] = np.nan
    x[3:9] = np.round(x[3:9] * 4) / 4
    x[9, 1], x[9, 4] = -0.0, 0.0
    t[9] = 1
    t[10:16] = [-1, -C, C, -C - 1, 10 * C, -5]
    if dtype != np.float32:
        x = np.nan_to_num(x * 100).astype(dtype)
    return x, t


def _hit_cases():
    return [(k, dtype) for k in (None, 1, 3, C - 1, C, C + 5)
            for dtype in (np.float32, np.int32, np.uint8)]


@pytest.mark.parametrize("k,dtype", _hit_cases())
def test_hit_rate_matches_jax_bitwise(k, dtype):
    x, t = _ranked(1, dtype=dtype)
    _same(TF.hit_rate(x, t, k=k, device=CPU), JF.hit_rate(x, t, k=k))


@pytest.mark.parametrize("k,dtype", _hit_cases())
def test_reciprocal_rank_matches_jax_bitwise(k, dtype):
    x, t = _ranked(2, dtype=dtype)
    _same(TF.reciprocal_rank(x, t, k=k, device=CPU), JF.reciprocal_rank(x, t, k=k))


def test_out_of_range_targets_never_reach_gather(monkeypatch):
    """Every index handed to ``torch.gather`` lies in range, and the wrap
    and NaN rules hold: the probe rows of the JAX package."""
    real = torch.gather
    seen = []

    def checked(input, dim, index, *a, **kw):
        seen.append(index)
        assert bool(((index >= 0) & (index < input.shape[dim])).all()), index
        return real(input, dim, index, *a, **kw)

    monkeypatch.setattr(torch, "gather", checked)
    x = np.array([[.3, .1, .6], [.5, .2, .3], [.1, .9, .2], [.4, np.nan, .1]], np.float32)
    np.testing.assert_array_equal(_np(TF.hit_rate(x, np.array([2, 1, 5, 1]), k=1, device=CPU)),
                                  [1, 0, 1, 1])
    np.testing.assert_allclose(_np(TF.reciprocal_rank(x, np.array([2, -1, 0, 1]), device=CPU)),
                               [1, .5, 1 / 3, 1], rtol=1e-7)
    assert seen


def test_empty_rows_and_classes_match_jax():
    _same(TF.reciprocal_rank(np.zeros((3, 0), np.float32), np.array([0, 1, -1]), device=CPU),
          JF.reciprocal_rank(np.zeros((3, 0), np.float32), np.array([0, 1, -1])))
    _same(TF.hit_rate(np.zeros((0, 4), np.float32), np.zeros(0, np.int64), k=2, device=CPU),
          JF.hit_rate(np.zeros((0, 4), np.float32), np.zeros(0, np.int64), k=2))


# ---------------------------------------------------- retrieval precision


def _retrieval(seed, shape, target_dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = np.round(rng.random(shape) * 6).astype(np.float32) / 6  # many ties
    x.reshape(-1)[:4] = [np.nan, -0.0, 0.0, np.inf]
    y = (rng.random(shape) < 0.35).astype(target_dtype)
    return x, y


# limit_k_to_size needs k (both packages raise without it)
@pytest.mark.parametrize("k,limit", [(None, False)] + [(k, lim) for k in (1, 4, 9, 40)
                                                      for lim in (False, True)])
@pytest.mark.parametrize("num_tasks", [1, 3])
def test_retrieval_precision_matches_jax_bitwise(num_tasks, k, limit):
    shape = (30,) if num_tasks == 1 else (num_tasks, 30)
    for target_dtype in (np.float32, np.int64, np.bool_):
        x, y = _retrieval(num_tasks, shape, target_dtype)
        _same(TF.retrieval_precision(x, y, k, limit, num_tasks, device=CPU),
              JF.retrieval_precision(x, y, k, limit, num_tasks))


def test_retrieval_precision_divides_as_xla_does():
    """XLA multiplies by the float32 reciprocal of a divisor fixed when it
    traces; plain division would differ here (3 / 7)."""
    x = np.arange(10, dtype=np.float32)
    y = np.array([1, 1, 1, 0, 0, 0, 0, 1, 1, 1], np.float32)
    got = TF.retrieval_precision(x, y, k=7, device=CPU)
    _same(got, JF.retrieval_precision(x, y, k=7))
    assert _np(got).view(np.int32) != (np.float32(3) / np.float32(7)).view(np.int32)


# ---------------------------------------------------- frequency, collisions


@pytest.mark.parametrize("k", [0.0, 0.25, 0.5, 3.0])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int64])
def test_frequency_at_k_matches_jax_bitwise(dtype, k):
    rng = np.random.default_rng(5)
    x = (rng.random(100) * 4).astype(dtype)
    if dtype != np.int64:
        x[:4] = [0.25, 0.5, np.nan, -0.0]
    _same(TF.frequency_at_k(x, k, device=CPU), JF.frequency_at_k(x, k))


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.uint8])
def test_num_collisions_matches_jax_bitwise(dtype):
    rng = np.random.default_rng(6)
    x = rng.integers(0, 40, 500).astype(dtype)
    _same(TF.num_collisions(x, device=CPU), JF.num_collisions(x))
    _same(TF.num_collisions(np.zeros(0, dtype), device=CPU), JF.num_collisions(np.zeros(0, dtype)))


def test_num_collisions_never_builds_the_pairwise_matrix():
    """2^17 ids: an (N, N) compare would allocate 16 GiB; the count goes
    through a sort, checked against numpy's unique counts."""
    rng = np.random.default_rng(7)
    ids = np.floor(40_000_000 * rng.random(1 << 17) ** 4).astype(np.int64)
    _, inverse, counts = np.unique(ids, return_inverse=True, return_counts=True)
    _same(TF.num_collisions(ids, device=CPU), (counts[inverse] - 1).astype(np.int32))


# ------------------------------------------------------------------ classes


def _ctr_batches(seed, tasks=1, weights=None):
    out = []
    for i, n in enumerate((90, 60, 33)):
        shape = (n,) if tasks == 1 else (tasks, n)
        x = _clicks(seed + i, shape)
        w = weights
        if weights == "tensor":
            w = np.random.default_rng(seed + 40 + i).random(shape).astype(np.float32)
        out.append(((x,) if w is None else (x, w), {}))
    return out


def _wc_batches(seed, tasks=1, weight=1.0, rows=False):
    out = []
    for i, n in enumerate((90, 60, 33)):
        rng = np.random.default_rng(seed + i)
        shape = (n,) if tasks == 1 or rows else (tasks, n)
        p = rng.random(shape).astype(np.float32)
        y = (rng.random(shape) < p).astype(np.float32)
        w = rng.random(shape).astype(np.float32) if weight == "tensor" else weight
        kw = {"task_ids": rng.integers(-2, tasks + 2, n)} if rows else {}
        out.append(((p, y, w), kw))
    return out


def _rank_batches(seed):
    out = []
    for i, n in enumerate((40, 30, 17)):
        x, t = _ranked(seed + i, n)
        out.append(((x, t), {}))
    return out


def _rp_batches(seed, queries=1):
    out = []
    for i, n in enumerate((40, 30, 17)):
        x, y = _retrieval(seed + i, (n,))
        rng = np.random.default_rng(seed + 70 + i)
        if queries == 1:
            out.append(((x, y), {}))
        else:
            idx = rng.integers(-1, queries + 1, n)  # a few outside the range
            y[idx == 1] = 0.0  # query 1 never sees a positive
            idx[idx == queries - 1] = 0  # the last query sees no row
            out.append(((x, y), {"indexes": idx}))
    return out


# name -> (constructor given the package and device kwargs, batch maker)
CASES = {
    "ctr": (lambda P, **k: P.ClickThroughRate(**k), _ctr_batches),
    "ctr_tasks_tensor": (lambda P, **k: P.ClickThroughRate(num_tasks=3, **k),
                         lambda s: _ctr_batches(s, 3, "tensor")),
    "ctr_scalar_int": (lambda P, **k: P.ClickThroughRate(**k), lambda s: _ctr_batches(s, 1, 3)),
    "ctr_zero_weight": (lambda P, **k: P.ClickThroughRate(**k), lambda s: _ctr_batches(s, 1, 0.0)),
    "wc": (lambda P, **k: P.WeightedCalibration(**k), _wc_batches),
    "wc_tasks_tensor": (lambda P, **k: P.WeightedCalibration(num_tasks=3, **k),
                        lambda s: _wc_batches(s, 3, "tensor")),
    "wc_rows_scalar": (lambda P, **k: P.WeightedCalibration(num_tasks=4, **k),
                       lambda s: _wc_batches(s, 4, 2.0, rows=True)),
    "wc_rows_tensor": (lambda P, **k: P.WeightedCalibration(num_tasks=4, **k),
                       lambda s: _wc_batches(s, 4, "tensor", rows=True)),
    "hit_rate_k3": (lambda P, **k: P.HitRate(k=3, **k), _rank_batches),
    "hit_rate_all": (lambda P, **k: P.HitRate(**k), _rank_batches),
    "reciprocal_rank": (lambda P, **k: P.ReciprocalRank(**k), _rank_batches),
    "reciprocal_rank_k2": (lambda P, **k: P.ReciprocalRank(k=2, **k), _rank_batches),
    "rp_k3": (lambda P, **k: P.RetrievalPrecision(k=3, **k), _rp_batches),
    "rp_all": (lambda P, **k: P.RetrievalPrecision(**k), _rp_batches),
    "rp_queries_neg": (lambda P, **k: P.RetrievalPrecision(k=4, num_queries=5, **k),
                       lambda s: _rp_batches(s, 5)),
    "rp_queries_pos_limited": (lambda P, **k: P.RetrievalPrecision(
        "pos", k=30, limit_k_to_size=True, num_queries=5, **k), lambda s: _rp_batches(s, 5)),
    "rp_queries_skip_macro": (lambda P, **k: P.RetrievalPrecision(
        "skip", k=2, num_queries=5, avg="macro", **k), lambda s: _rp_batches(s, 5)),
}
NAMES = sorted(CASES)
BITWISE = {n for n in NAMES if not n.startswith("wc") and n != "ctr_tasks_tensor"}


def _feed(metric, batches):
    for args, kw in batches:
        metric.update(*args, **kw)
    return metric


def _state_arrays(sd):
    """name -> list of numpy arrays (a list state flattened; a scalar
    state as a 0-d array)."""
    out = {}
    for name, value in sd.items():
        values = value if isinstance(value, list) else [value]
        out[name] = [_np(v) for v in values]
    return out


def _assert_states(tm, jm, bitwise):
    ours, theirs = _state_arrays(tm.state_dict()), _state_arrays(jm.state_dict())
    assert sorted(ours) == sorted(theirs)
    for name in theirs:
        assert len(ours[name]) == len(theirs[name]), name
        for a, b in zip(ours[name], theirs[name]):
            assert a.dtype == b.dtype and a.shape == b.shape, (name, a.dtype, b.dtype)
            if bitwise or a.dtype.kind in "iub":
                assert a.tobytes() == b.tobytes(), name
            else:
                np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-6, err_msg=name)


def _check(got, want, bitwise):
    (_same if bitwise else _close)(got, want)


@pytest.mark.parametrize("name", NAMES)
def test_class_update_compute_reset_matches_jax(name):
    make, batches = CASES[name]
    bitwise = name in BITWISE
    tm, jm = make(TM, device=CPU), make(JM)
    _assert_states(tm, jm, True)
    _feed(tm, batches(10))
    _feed(jm, batches(10))
    _assert_states(tm, jm, bitwise)
    _check(tm.compute(), jm.compute(), bitwise)
    _check(tm.compute(), jm.compute(), bitwise)  # idempotent
    tm.reset()
    jm.reset()
    _assert_states(tm, jm, True)
    _feed(tm, batches(20)[:1])
    _feed(jm, batches(20)[:1])
    _check(tm.compute(), jm.compute(), bitwise)


@pytest.mark.parametrize("name", NAMES)
def test_class_merge_then_compute_matches_jax(name):
    make, batches = CASES[name]
    stream = batches(30)
    tms = [_feed(make(TM, device=CPU), [b]) for b in stream]
    jms = [_feed(make(JM), [b]) for b in stream]
    tms[0].merge_state(tms[1:])
    jms[0].merge_state(jms[1:])
    _assert_states(tms[0], jms[0], name in BITWISE)
    _check(tms[0].compute(), jms[0].compute(), name in BITWISE)
    # the merged metric keeps updating like the JAX one
    _feed(tms[0], stream[:1])
    _feed(jms[0], stream[:1])
    _check(tms[0].compute(), jms[0].compute(), name in BITWISE)


def _to_jax(sd):
    def conv(v):
        if isinstance(v, np.ndarray):
            return jnp.asarray(v)
        if isinstance(v, list):
            return [jnp.asarray(a) for a in v]
        return v

    return {k: conv(v) for k, v in sd.items()}


def _numpy_sd(jm):
    def conv(v):
        return [np.asarray(a) for a in v] if isinstance(v, list) else (
            v if isinstance(v, (int, float)) else np.asarray(v))

    return {k: conv(v) for k, v in jm.state_dict().items()}


@pytest.mark.parametrize("updated", [False, True], ids=["fresh", "updated"])
@pytest.mark.parametrize("name", NAMES)
def test_state_dict_cross_loads_both_ways(name, updated):
    make, batches = CASES[name]
    jm = _feed(make(JM), batches(40) if updated else [])
    tm = make(TM, device=CPU)
    load_numpy_state_dict(tm, _numpy_sd(jm))
    _assert_states(tm, jm, True)
    back = make(JM)
    back.load_state_dict(_to_jax(numpy_state_dict(tm)))
    _assert_states(tm, back, True)
    more = batches(50)[:2]
    _feed(tm, more)
    _feed(back, more)
    _assert_states(tm, back, name in BITWISE)
    _check(tm.compute(), back.compute(), name in BITWISE)


def test_local_replica_sync_of_the_family_equals_jax():
    names = ["ctr_tasks_tensor", "wc_rows_tensor", "hit_rate_k3", "reciprocal_rank",
             "rp_queries_neg", "rp_k3"]
    world = 3
    tgroup = tdist.LocalReplicaGroup([torch.device(CPU)] * world)
    jgroup = jdist.LocalReplicaGroup(jax.devices("cpu")[:world])
    treps = [{n: CASES[n][0](TM, device=CPU) for n in names} for _ in range(world)]
    jreps = [{n: CASES[n][0](JM) for n in names} for _ in range(world)]
    for n in names:
        for r, (args, kw) in enumerate(CASES[n][1](60)):
            treps[r][n].update(*args, **kw)
            jreps[r][n].update(*args, **kw)
    tsynced = ttoolkit.get_synced_metric_collection(treps, tgroup)
    jsynced = jtoolkit.get_synced_metric_collection(jreps, jgroup)
    for n in names:
        _assert_states(tsynced[n], jsynced[n], n in BITWISE)
        _check(tsynced[n].compute(), jsynced[n].compute(), n in BITWISE)


def test_update_collection_runs_the_plans():
    p, y, w = _wc_batches(80, 1, "tensor")[0][0]
    coll = {"wc": TM.WeightedCalibration(device=CPU), "ctr": TM.ClickThroughRate(device=CPU)}
    ttoolkit.update_collection({"wc": coll["wc"]}, p, y, w)
    ttoolkit.update_collection({"ctr": coll["ctr"]}, y, w)
    _close(coll["wc"].compute(), JM.WeightedCalibration().update(p, y, w).compute())
    _close(coll["ctr"].compute(), JM.ClickThroughRate().update(y, w).compute())


def test_calibration_with_a_zero_target_sum_is_empty():
    p = np.array([[0.2, 0.4], [0.3, 0.1]], np.float32)
    y = np.array([[1.0, 0.0], [0.0, 0.0]], np.float32)
    tm = TM.WeightedCalibration(num_tasks=2, device=CPU).update(p, y)
    jm = JM.WeightedCalibration(num_tasks=2).update(p, y)
    _same(tm.compute(), jm.compute())
    assert tm.compute().shape == (0,)


def test_calibration_rows_drop_out_of_range_ids():
    p = np.array([0.5, 0.25, 0.75, 1.0, 0.5], np.float32)
    y = np.array([1.0, 0.0, 1.0, 1.0, 0.0], np.float32)
    ids = np.array([0, 1, -1, 2, 1 << 20])
    tm = TM.WeightedCalibration(num_tasks=3, device=CPU).update(p, y, task_ids=ids)
    jm = JM.WeightedCalibration(num_tasks=3).update(p, y, task_ids=ids)
    _assert_states(tm, jm, True)
    np.testing.assert_array_equal(tm.weighted_input_sum.numpy(), [0.5, 0.25, 1.0])


def test_sharded_calibration_is_not_ported_yet():
    """Sharded since the sharded-state slice: rank 0 of 2 keeps two of the
    four task rows and routes foreign rows through the float outbox lane,
    bit for bit as the JAX package does."""
    rng = np.random.default_rng(7)
    p, y = rng.random(24).astype(np.float32), rng.integers(0, 2, 24).astype(np.float32)
    w, ids = rng.random(24).astype(np.float32), rng.integers(0, 4, 24)
    tm = TM.WeightedCalibration(num_tasks=4, device=CPU, shard=TM.ShardContext(0, 2))
    jm = JM.WeightedCalibration(num_tasks=4, shard=JM.ShardContext(0, 2))
    tm.update(torch.from_numpy(p), torch.from_numpy(y), torch.from_numpy(w),
              task_ids=torch.from_numpy(ids))
    jm.update(jnp.asarray(p), jnp.asarray(y), jnp.asarray(w), task_ids=jnp.asarray(ids))
    assert tuple(tm.weighted_input_sum.shape) == (2,)
    for name, value in jm.state_dict().items():
        ours = getattr(tm, name)
        ours = ours.numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
        assert ours.tobytes() == np.asarray(value).tobytes(), name


@pytest.mark.parametrize("bad", [
    dict(empty_target_action="maybe"), dict(avg="micro"), dict(k=0),
    dict(limit_k_to_size=True),
])
def test_retrieval_precision_arguments_raise_like_jax(bad):
    with pytest.raises(ValueError):
        JM.RetrievalPrecision(**bad)
    with pytest.raises(ValueError):
        TM.RetrievalPrecision(**bad, device=CPU)


def test_retrieval_precision_err_action_raises_like_jax():
    x, y = np.array([0.3, 0.1, 0.2], np.float32), np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="no positive value found"):
        JM.RetrievalPrecision("err", k=2).update(x, y).compute()
    with pytest.raises(ValueError, match="no positive value found"):
        TM.RetrievalPrecision("err", k=2, device=CPU).update(x, y).compute()


def test_retrieval_precision_needs_indexes_for_many_queries():
    x, y = _retrieval(3, (6,))
    for m in (JM.RetrievalPrecision(num_queries=2), TM.RetrievalPrecision(num_queries=2, device=CPU)):
        with pytest.raises(ValueError, match="indexes"):
            m.update(x, y)


def test_retrieval_precision_one_update_equals_one_query_at_a_time():
    """The batched ranking of every touched query equals ranking each
    query's rows alone, on shuffled rows with ties."""
    rng = np.random.default_rng(90)
    queries, n = 7, 400
    x = (np.round(rng.random(n) * 3) / 3).astype(np.float32)
    y = (rng.random(n) < 0.3).astype(np.float32)
    idx = rng.integers(0, queries, n)
    many = TM.RetrievalPrecision(k=5, num_queries=queries, device=CPU).update(x, y, idx)
    for q in range(queries):
        one = TM.RetrievalPrecision(k=5, device=CPU).update(x[idx == q], y[idx == q])
        assert torch.equal(many.topk[q], one.topk[0]) and torch.equal(many.target[q], one.target[0])


@pytest.mark.parametrize("make", [
    lambda **k: TM.ClickThroughRate(**k),
    lambda **k: TM.WeightedCalibration(**k),
    lambda **k: TM.HitRate(**k),
    lambda **k: TM.ReciprocalRank(**k),
    lambda **k: TM.RetrievalPrecision(**k),
])
def test_classes_default_to_cuda(make):
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert make(device=CPU).device == torch.device(CPU)


_DOC_MODULES = [
    "torcheval_tpu_torch.metrics.functional.classification.binary_normalized_entropy",
    "torcheval_tpu_torch.metrics.classification.binary_normalized_entropy",
    *[f"torcheval_tpu_torch.metrics.functional.ranking.{m}" for m in (
        "click_through_rate", "frequency", "hit_rate", "num_collisions", "reciprocal_rank",
        "retrieval_precision", "weighted_calibration")],
    *[f"torcheval_tpu_torch.metrics.ranking.{m}" for m in (
        "click_through_rate", "hit_rate", "reciprocal_rank", "retrieval_precision",
        "weighted_calibration")],
]


@pytest.mark.parametrize("module", _DOC_MODULES, ids=lambda m: m.rsplit(".", 2)[-2] + "." + m.rsplit(".", 1)[-1])
def test_docstring_examples_run(module):
    result = doctest.testmod(importlib.import_module(module),
                             optionflags=doctest.NORMALIZE_WHITESPACE)
    assert result.attempted > 0 and result.failed == 0
