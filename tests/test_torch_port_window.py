"""torcheval_tpu_torch's windowed metrics -- ``WindowedBinaryNormalizedEntropy``,
``WindowedClickThroughRate``, ``WindowedWeightedCalibration``,
``WindowedMeanSquaredError`` and ``WindowedBinaryAUROC`` -- against the JAX
package on the same numpy inputs: states (names, shapes, dtypes, values),
the ring cursor and the computed values after every update; merge, update
and compute sequences (the reference's cursor quirk after a merge);
``state_dict`` cross-loads both ways, with and without a cursor; the
AUROC ring's fits, wraps and oversized inserts, its zero-suffix probe and
its trimmed sync payload; ``update_collection``; a ``LocalReplicaGroup``
sync with a wrapped replica; reset, ``to``, pickling and
``MetricClassTester``.

Tolerances: integer states and the cursor are held bitwise, and so are
the AUROC rings, which only move values. Float counters and values are
held within rtol 1e-5 (atol 1e-6): torch and XLA sum a batch, and a ring
row, in different orders.
"""

from __future__ import annotations

import copy
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as JM
from torcheval_tpu import distributed as jdist
from torcheval_tpu.metrics import toolkit as jtoolkit
import torcheval_tpu_torch.metrics as TM
from torcheval_tpu_torch import distributed as tdist
from torcheval_tpu_torch.metrics import toolkit as ttoolkit
from torcheval_tpu_torch.utils import load_numpy_state_dict, numpy_state_dict
from torcheval_tpu_torch.utils.test_utils import MetricClassTester

CPU = "cpu"
RTOL, ATOL = 1e-5, 1e-6
N = 12  # samples a batch
KINDS = ("ne", "ne_logits", "ctr", "wc", "mse")


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _make(kind, P, tasks=1, window=3, lifetime=True, **kw):
    if kind == "auroc":
        return P.WindowedBinaryAUROC(num_tasks=tasks, max_num_samples=window, **kw)
    common = dict(num_tasks=tasks, max_num_updates=window, enable_lifetime=lifetime, **kw)
    if kind == "ne":
        return P.WindowedBinaryNormalizedEntropy(**common)
    if kind == "ne_logits":
        return P.WindowedBinaryNormalizedEntropy(from_logits=True, **common)
    if kind == "ctr":
        return P.WindowedClickThroughRate(**common)
    if kind == "wc":
        return P.WindowedWeightedCalibration(**common)
    return P.WindowedMeanSquaredError(
        multioutput="raw_values" if tasks > 1 else "uniform_average", **common)


def _batches(kind, count, tasks=1, weighted=False, seed=0, n=N):
    """``count`` (args, kwargs) update batches for ``kind``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        if kind == "mse":
            shape = (n,) if tasks == 1 else (n, tasks)
            x = rng.random(shape).astype(np.float32)
            y = rng.random(shape).astype(np.float32)
            kw = {"sample_weight": rng.random(n).astype(np.float32)} if weighted else {}
            out.append(((x, y), kw))
            continue
        shape = (n,) if tasks == 1 else (tasks, n)
        p = rng.uniform(0.02, 0.98, shape).astype(np.float32)
        y = (rng.random(shape) < p).astype(np.float32)
        w = rng.random(shape).astype(np.float32)
        if kind == "ne_logits":
            p = np.log(p / (1 - p)).astype(np.float32)
        if kind in ("ne", "ne_logits"):
            out.append(((p, y), {"weight": w} if weighted else {}))
        elif kind == "ctr":
            out.append(((y, w) if weighted else (y,), {}))
        else:  # wc, auroc
            out.append(((p, y, w) if weighted else (p, y), {}))
    return out


def _feed(m, batches):
    for args, kw in batches:
        m.update(*args, **kw)
    return m


def _assert_value(got, want, bitwise=False):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_value(g, w, bitwise)
        return
    g, w = _np(got), np.asarray(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, g.dtype, w.shape, w.dtype)
    if bitwise:
        assert g.tobytes() == w.tobytes(), (g, w)
    else:
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, equal_nan=True)


def _assert_states(tm, jm, bitwise=False):
    assert set(tm._state_name_to_default) == set(jm._state_name_to_default)
    assert tm.next_inserted == jm.next_inserted
    for name in tm._state_name_to_default:
        a, b = getattr(tm, name), getattr(jm, name)
        if isinstance(b, int):
            assert type(a) is int and a == b, (name, a, b)
            continue
        assert tm._state_name_to_merge_kind[name].value == "custom", name
        a, b = _np(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (name, a.shape, b.shape, a.dtype, b.dtype)
        if bitwise:
            assert a.tobytes() == b.tobytes(), name
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)


def _numpy_sd(jm):
    return {k: v if isinstance(v, (int, float)) else np.asarray(v)
            for k, v in jm.state_dict().items()}


def _to_jax(sd):
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in sd.items()}


# ------------------------------------------------------- the counter windows


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("window", [1, 3])
@pytest.mark.parametrize("lifetime", [True, False], ids=["lifetime", "window_only"])
@pytest.mark.parametrize("tasks", [1, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_every_update_matches_jax(kind, tasks, lifetime, window, weighted):
    """States, cursor and value after every update; empty before any."""
    tm = _make(kind, TM, tasks, window, lifetime, device=CPU)
    jm = _make(kind, JM, tasks, window, lifetime)
    _assert_states(tm, jm, bitwise=True)
    _assert_value(tm.compute(), jm.compute(), bitwise=True)
    for args, kw in _batches(kind, 5, tasks, weighted, seed=tasks + 10 * window):
        tm.update(*args, **kw)
        jm.update(*args, **kw)
        _assert_states(tm, jm)
        _assert_value(tm.compute(), jm.compute())
    assert tm.total_updates == 5 and tm.next_inserted == 5 % window


@pytest.mark.parametrize("kind", KINDS + ("auroc",))
def test_merge_update_compute_sequence_matches_jax(kind):
    """Three replicas (one wrapped, one partial, one empty) merge into a
    fourth; the merged metric keeps updating at the reduced cursor of its
    enlarged buffer, merges again and computes as the JAX package does."""
    window = 8 if kind == "auroc" else 3
    counts = (4, 2, 0, 1)
    stream = _batches(kind, sum(counts) + 4, 1, True, seed=7, n=3)
    pairs, start = [], 0
    for c in counts:
        pairs.append((_feed(_make(kind, TM, 1, window, device=CPU), stream[start:start + c]),
                      _feed(_make(kind, JM, 1, window), stream[start:start + c])))
        start += c
    (t0, j0), rest = pairs[0], pairs[1:]
    t0.merge_state([t for t, _ in rest[:2]])
    j0.merge_state([j for _, j in rest[:2]])
    _assert_states(t0, j0)
    _assert_value(t0.compute(), j0.compute())
    for args, kw in stream[start:start + 4]:
        t0.update(*args, **kw)
        j0.update(*args, **kw)
        _assert_states(t0, j0)
        _assert_value(t0.compute(), j0.compute())
    t0.merge_state([rest[2][0]])
    j0.merge_state([rest[2][1]])
    _assert_states(t0, j0)
    _assert_value(t0.compute(), j0.compute())
    # the peers are untouched by the merge
    for t, j in rest:
        _assert_states(t, j)


@pytest.mark.parametrize("updates", [0, 2, 5])
@pytest.mark.parametrize("kind", KINDS + ("auroc",))
def test_state_dict_cross_loads_both_ways(kind, updates):
    stream = _batches(kind, updates + 2, 3 if kind != "auroc" else 1, True, seed=3, n=5)
    window = 7 if kind == "auroc" else 3
    tasks = 1 if kind == "auroc" else 3
    jm = _feed(_make(kind, JM, tasks, window), stream[:updates])
    tm = _make(kind, TM, tasks, window, device=CPU)
    load_numpy_state_dict(tm, _numpy_sd(jm))
    _assert_states(tm, jm, bitwise=True)
    back = _make(kind, JM, tasks, window)
    back.load_state_dict(_to_jax(numpy_state_dict(tm)))
    _assert_states(tm, back, bitwise=True)
    # a snapshot without a cursor re-derives it from the update count
    sd = numpy_state_dict(tm)
    del sd["next_inserted"]
    legacy, jlegacy = _make(kind, TM, tasks, window, device=CPU), _make(kind, JM, tasks, window)
    load_numpy_state_dict(legacy, sd)
    jlegacy.load_state_dict(_to_jax(sd))
    _assert_states(legacy, jlegacy, bitwise=True)
    for m in (tm, back, legacy, jlegacy):
        _feed(m, stream[updates:])
    _assert_states(tm, back)
    _assert_states(legacy, jlegacy)
    _assert_value(tm.compute(), back.compute())


def test_mse_lifetime_states_promote_like_jax():
    """Scalar lifetime states until a multioutput update makes the error
    sum per output; the weight sum stays a scalar."""
    tm = TM.WindowedMeanSquaredError(num_tasks=3, max_num_updates=2, device=CPU)
    jm = JM.WindowedMeanSquaredError(num_tasks=3, max_num_updates=2)
    assert tuple(tm.sum_squared_error.shape) == jm.sum_squared_error.shape == ()
    for args, kw in _batches("mse", 2, 3, True, seed=5):
        tm.update(*args, **kw)
        jm.update(*args, **kw)
        _assert_states(tm, jm)
    assert tuple(tm.sum_squared_error.shape) == (3,) and tuple(tm.sum_weight.shape) == ()
    _assert_value(tm.compute(), jm.compute())


def test_windowed_ctr_shard_is_not_ported_yet():
    """Sharded since the sharded-state slice: rank 1 of 2 keeps task rows
    2-3 of the rings and lifetime totals, as the JAX package does."""
    rng = np.random.default_rng(8)
    tm = TM.WindowedClickThroughRate(num_tasks=4, max_num_updates=3, device=CPU,
                                     shard=TM.ShardContext(1, 2))
    jm = JM.WindowedClickThroughRate(num_tasks=4, max_num_updates=3, shard=JM.ShardContext(1, 2))
    for _ in range(4):
        x = rng.integers(0, 2, (4, 10)).astype(np.float32)
        tm.update(torch.from_numpy(x))
        jm.update(jnp.asarray(x))
    assert tuple(tm.windowed_click_total.shape) == (2, 3)
    for name, value in jm.state_dict().items():
        ours = getattr(tm, name)
        ours = ours.numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
        assert ours.tobytes() == np.asarray(value).tobytes(), name
    for a, b in zip(tm.compute(), jm.compute()):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()


@pytest.mark.parametrize("bad", [dict(num_tasks=0), dict(max_num_updates=0)])
@pytest.mark.parametrize("kind", KINDS)
def test_bad_window_arguments_raise_like_jax(kind, bad):
    with pytest.raises(ValueError) as jerr:
        _make(kind, JM, **{"tasks": bad.get("num_tasks", 1), "window": bad.get("max_num_updates", 3)})
    with pytest.raises(ValueError) as terr:
        _make(kind, TM, **{"tasks": bad.get("num_tasks", 1), "window": bad.get("max_num_updates", 3)},
              device=CPU)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("kind", KINDS + ("auroc",))
def test_reset_to_and_pickle_match_jax(kind):
    stream = _batches(kind, 6, 1, False, seed=9, n=4)
    window = 6 if kind == "auroc" else 2
    tm = _feed(_make(kind, TM, 1, window, device=CPU), stream[:4])
    jm = _feed(_make(kind, JM, 1, window), stream[:4])
    again = pickle.loads(pickle.dumps(tm))
    _assert_states(again, jm)
    _assert_value(again.compute(), jm.compute())
    assert tm.to(CPU) is tm and tm.device == torch.device(CPU)
    # reset restores the states but, as in the reference, not the cursor
    tm.reset()
    jm.reset()
    _assert_states(tm, jm, bitwise=True)
    for m in (tm, jm, again):
        _feed(m, stream[4:])
    _assert_states(tm, jm)
    _assert_value(tm.compute(), jm.compute())


# ------------------------------------------------------------ AUROC window


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("tasks", [1, 3])
def test_auroc_fits_wraps_and_oversized_inserts_match_jax(tasks, weighted):
    """Capacity 8: batches that fit, wrap, fill it exactly and overflow
    it; the rings move values, so they are held bitwise."""
    sizes = (3, 4, 3, 8, 2, 11, 5, 7)
    rng = np.random.default_rng(tasks)
    tm = TM.WindowedBinaryAUROC(num_tasks=tasks, max_num_samples=8, device=CPU)
    jm = JM.WindowedBinaryAUROC(num_tasks=tasks, max_num_samples=8)
    for n in sizes:
        shape = (n,) if tasks == 1 else (tasks, n)
        x = rng.random(shape).astype(np.float32)
        y = rng.integers(0, 2, shape).astype(np.int32)
        w = rng.random(shape).astype(np.float32) if weighted else None
        tm.update(x, y, w)
        jm.update(x, y, w)
        _assert_states(tm, jm, bitwise=True)
        _assert_value(tm.compute(), jm.compute())
    assert tm.total_samples == sum(sizes)


def test_auroc_zero_suffix_probe_with_real_zero_scores_matches_jax():
    """A wrapped ring whose columns past the cursor hold real zero scores
    reads as a partial window: only the columns before the cursor count."""
    tm = TM.WindowedBinaryAUROC(max_num_samples=6, device=CPU)
    jm = JM.WindowedBinaryAUROC(max_num_samples=6)
    feeds = [(np.array([0.4, 0.7, 0.0, 0.0], np.float32), np.array([0, 1, 1, 0])),
             (np.array([0.0, 0.0, 0.9, 0.2], np.float32), np.array([1, 0, 1, 0]))]
    for x, y in feeds:
        tm.update(x, y)
        jm.update(x, y)
    assert tm.next_inserted == 2 and not bool(torch.any(tm.inputs[:, 2:]))
    _assert_states(tm, jm, bitwise=True)
    _assert_value(tm.compute(), jm.compute(), bitwise=True)


def test_auroc_one_sample_window_raises_like_jax():
    tm = TM.WindowedBinaryAUROC(max_num_samples=4, device=CPU).update([0.5], [1])
    jm = JM.WindowedBinaryAUROC(max_num_samples=4).update(np.array([0.5]), np.array([1]))
    with pytest.raises(IndexError):
        jm.compute()
    with pytest.raises(IndexError):
        tm.compute()


@pytest.mark.parametrize("samples", [0, 5, 8, 13])
def test_auroc_sync_payload_is_trimmed_like_jax(samples):
    rng = np.random.default_rng(samples)
    tm = TM.WindowedBinaryAUROC(num_tasks=2, max_num_samples=8, device=CPU)
    jm = JM.WindowedBinaryAUROC(num_tasks=2, max_num_samples=8)
    if samples:
        x = rng.random((2, samples)).astype(np.float32)
        y = rng.integers(0, 2, (2, samples))
        tm.update(x, y)
        jm.update(x, y)
    got, want = tm._sync_state_dict(), jm._sync_state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, int):
            assert got[k] == v
        else:
            _assert_value(got[k], v, bitwise=True)
    assert got["inputs"].shape[1] == min(samples, 8)


# ---------------------------------------------------- collections and sync


def test_update_collection_advances_each_cursor_once():
    tcoll = {"ne": _make("ne", TM, window=3, device=CPU), "wc": _make("wc", TM, window=3, device=CPU),
             "mse": _make("mse", TM, window=3, device=CPU),
             "auroc": _make("auroc", TM, window=20, device=CPU)}
    jcoll = {"ne": _make("ne", JM, window=3), "wc": _make("wc", JM, window=3),
             "mse": _make("mse", JM, window=3), "auroc": _make("auroc", JM, window=20)}
    tctr, jctr = _make("ctr", TM, window=3, device=CPU), _make("ctr", JM, window=3)
    for k, ((p, y), _) in enumerate(_batches("wc", 4, seed=2, n=6), start=1):
        ttoolkit.update_collection(tcoll, p, y)
        jtoolkit.update_collection(jcoll, p, y)
        ttoolkit.update_collection({"ctr": tctr}, y)
        jtoolkit.update_collection({"ctr": jctr}, y)
        for name in ("ne", "wc", "mse"):
            assert tcoll[name].next_inserted == k % 3 and tcoll[name].total_updates == k
        assert tcoll["auroc"].next_inserted == 6 * k % 20 and tctr.total_updates == k
        for name in tcoll:
            _assert_states(tcoll[name], jcoll[name])
        _assert_states(tctr, jctr)
    for name in tcoll:
        _assert_value(tcoll[name].compute(), jcoll[name].compute())


def test_local_replica_sync_with_a_wrapped_replica_matches_jax():
    world = 3
    tgroup = tdist.LocalReplicaGroup([torch.device(CPU)] * world)
    jgroup = jdist.LocalReplicaGroup(jax.devices("cpu")[:world])
    kinds = KINDS + ("auroc",)
    windows = {k: 3 for k in KINDS}
    windows["auroc"] = 10
    treps = [{k: _make(k, TM, 1, windows[k], device=CPU) for k in kinds} for _ in range(world)]
    jreps = [{k: _make(k, JM, 1, windows[k]) for k in kinds} for _ in range(world)]
    for k in kinds:
        for r, count in enumerate((5, 1, 2)):  # replica 0 wraps, as its AUROC ring does
            stream = _batches(k, count, 1, True, seed=20 + r, n=4)
            _feed(treps[r][k], stream)
            _feed(jreps[r][k], stream)
    tsynced = ttoolkit.get_synced_metric_collection(treps, tgroup)
    jsynced = jtoolkit.get_synced_metric_collection(jreps, jgroup)
    tvalues = ttoolkit.sync_and_compute_collection(treps, tgroup)
    for k in kinds:
        _assert_states(tsynced[k], jsynced[k])
        _assert_value(tsynced[k].compute(), jsynced[k].compute())
        _assert_value(tvalues[k], jsynced[k].compute())
        # the sync equals merge_state on the same metrics
        merged = copy.deepcopy(treps[0][k]).merge_state([treps[1][k], treps[2][k]])
        _assert_states(tsynced[k], merged, bitwise=True)


# ------------------------------------------------------- the class harness


def _jax_expected(kind, window, stream, world):
    whole = _feed(_make(kind, JM, 1, window), stream).compute()
    per = len(stream) // world
    ranks = [_feed(_make(kind, JM, 1, window), stream[r * per:(r + 1) * per])
             for r in range(world)]
    ranks[0].merge_state(ranks[1:])
    return whole, ranks[0].compute()


class TestWindowedClasses(MetricClassTester):
    @pytest.mark.parametrize("kind", KINDS + ("auroc",))
    def test_class_contract(self, kind):
        updates, world = 8, 4
        window = 64 if kind == "auroc" else 5
        stream = _batches(kind, updates, 1, True, seed=31, n=6)
        whole, merged = _jax_expected(kind, window, stream, world)
        names = {"ctr": ("input", "weights")}.get(kind, ("input", "target", "weight"))
        update_kwargs = {name: [args[i] for args, _ in stream]
                         for i, name in enumerate(names[:len(stream[0][0])])}
        for key in stream[0][1]:
            update_kwargs[key] = [kw[key] for _, kw in stream]
        metric = _make(kind, TM, 1, window, device=CPU)
        self.run_class_implementation_tests(
            metric=metric,
            state_names=set(metric._state_name_to_default),
            update_kwargs=update_kwargs,
            compute_result=tuple(np.asarray(v) for v in whole) if isinstance(whole, tuple)
            else np.asarray(whole),
            merge_and_compute_result=tuple(np.asarray(v) for v in merged)
            if isinstance(merged, tuple) else np.asarray(merged),
            num_total_updates=updates,
            num_processes=world,
            atol=1e-6,
            rtol=1e-5,
        )
