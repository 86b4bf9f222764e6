"""torcheval_tpu_torch's growable example buffers and the buffered curve
classes against the JAX package on the same numpy inputs: the capacity
schedule, buffer states (bitwise, with equal dtypes and shapes) after
updates and merges, computed values (bitwise for curves, atol 1e-6 for
AUROC/AUPRC/recall scalars), ``_sync_state_dict`` trimming, and
``state_dict`` cross-loading JAX -> port -> JAX before the first update and
after growth."""

from __future__ import annotations

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as JM
from torcheval_tpu import distributed as jdist
from torcheval_tpu.metrics import _buffer as jbuffer
from torcheval_tpu.metrics import toolkit as jtoolkit
import torcheval_tpu_torch.metrics as TM
from torcheval_tpu_torch import distributed as tdist
from torcheval_tpu_torch.metrics import _buffer as tbuffer
from torcheval_tpu_torch.metrics import toolkit as ttoolkit
from torcheval_tpu_torch.utils import load_numpy_state_dict, numpy_state_dict

CPU = "cpu"
ATOL = 1e-6
C = 5  # classes / labels


def _scores(rng, shape):
    return (np.round(rng.random(shape) * 12) / 12).astype(np.float32)


def _binary(rng, n):
    s = _scores(rng, n)
    return (s, (rng.random(n) < s).astype(np.int64)), {}


def _binary_weighted_tasks(rng, n):
    s = _scores(rng, (2, n))
    t = (rng.random((2, n)) < s).astype(np.float32)
    return (s, t), {"weight": rng.random((2, n)).astype(np.float32)}


def _multiclass(rng, n):
    return (_scores(rng, (n, C)), rng.integers(0, C, n)), {}


def _multilabel(rng, n):
    s = _scores(rng, (n, C))
    return (s, (rng.random((n, C)) < s).astype(np.int64)), {}


# name -> (constructor given the package and device kwargs, batch maker)
CASES = {
    "binary_auroc": (lambda P, **k: P.BinaryAUROC(**k), _binary),
    "binary_auroc_tasks": (lambda P, **k: P.BinaryAUROC(num_tasks=2, **k), _binary_weighted_tasks),
    "binary_auroc_fused": (lambda P, **k: P.BinaryAUROC(use_fused=True, **k), _binary),
    "multiclass_auroc": (lambda P, **k: P.MulticlassAUROC(num_classes=C, **k), _multiclass),
    "multiclass_auroc_none": (lambda P, **k: P.MulticlassAUROC(num_classes=C, average=None, **k),
                              _multiclass),
    "binary_auprc": (lambda P, **k: P.BinaryAUPRC(**k), _binary),
    "multiclass_auprc": (lambda P, **k: P.MulticlassAUPRC(num_classes=C, **k), _multiclass),
    "multilabel_auprc": (lambda P, **k: P.MultilabelAUPRC(num_labels=C, average=None, **k),
                         _multilabel),
    "binary_prc": (lambda P, **k: P.BinaryPrecisionRecallCurve(**k), _binary),
    "multiclass_prc": (lambda P, **k: P.MulticlassPrecisionRecallCurve(num_classes=C, **k),
                       _multiclass),
    "multilabel_prc": (lambda P, **k: P.MultilabelPrecisionRecallCurve(num_labels=C, **k),
                       _multilabel),
    "binary_rafp": (lambda P, **k: P.BinaryRecallAtFixedPrecision(min_precision=0.6, **k), _binary),
    "multilabel_rafp": (lambda P, **k: P.MultilabelRecallAtFixedPrecision(
        num_labels=C, min_precision=0.4, **k), _multilabel),
}
NAMES = sorted(CASES)
SIZES = (30, 50, 70)  # 64 -> 128 -> 256: two growth steps


def _batches(name, seed, sizes=SIZES):
    rng = np.random.default_rng(seed)
    return [CASES[name][1](rng, n) for n in sizes]


def _pair(name):
    make = CASES[name][0]
    return make(TM, device=CPU), make(JM)


def _feed(metric, batches, torch_inputs=False):
    for args, kwargs in batches:
        if torch_inputs:
            args = tuple(torch.from_numpy(a) for a in args)
            kwargs = {k: torch.from_numpy(v) for k, v in kwargs.items()}
        metric.update(*args, **kwargs)
    return metric


def _leaves(value):
    if isinstance(value, (list, tuple)):
        return [leaf for v in value for leaf in _leaves(v)]
    return [np.asarray(value.numpy() if isinstance(value, torch.Tensor) else value)]


def _assert_values(name, got, want):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if name.endswith("_prc"):  # curve arrays: exact counts, bitwise
            assert g.tobytes() == w.tobytes()
        else:
            np.testing.assert_allclose(g, w, atol=ATOL)


def _assert_states(tm, jm):
    for name, value in jm.state_dict().items():
        ours = getattr(tm, name)
        if isinstance(value, int):
            assert ours == value
            continue
        value = np.asarray(value)
        assert ours.numpy().dtype == value.dtype, name
        assert ours.numpy().shape == value.shape, name
        assert ours.numpy().tobytes() == value.tobytes(), name


# ----------------------------------------------------------- capacity schedule


def test_capacity_schedule_matches_jax():
    assert tbuffer.MIN_CAPACITY == jbuffer.MIN_CAPACITY == 64
    for n in list(range(0, 300)) + [1023, 1024, 1025, 89_137_319, 2**27, 2**27 + 1]:
        assert tbuffer.next_capacity(n) == jbuffer.next_capacity(n), n
    assert tbuffer.next_capacity(89_137_319) == 2**27


def test_growth_keeps_fill_and_capacities_of_jax():
    tm, jm = _pair("binary_auroc")
    batches = _batches("binary_auroc", 1, sizes=(10, 60, 1, 200))
    for args, kwargs in batches:
        tm.update(*args, **kwargs)
        jm.update(*args, **kwargs)
        _assert_states(tm, jm)
    assert tm.inputs.shape == (512,) and tm.num_samples == 271
    assert torch.isinf(tm.inputs[271:]).all() and (tm.weights[271:] == 0).all()


# ------------------------------------------------------------ update/compute


@pytest.mark.parametrize("name", NAMES)
def test_multi_update_matches_jax(name):
    tm, jm = _pair(name)
    batches = _batches(name, 2)
    _feed(tm, batches, torch_inputs=True)
    _feed(jm, batches)
    _assert_states(tm, jm)
    _assert_values(name, tm.compute(), jm.compute())
    _assert_values(name, tm.compute(), jm.compute())  # compute is idempotent


@pytest.mark.parametrize("name", NAMES)
def test_multi_merge_matches_jax(name):
    per = [_batches(name, 10 + r, sizes=(20 + 40 * r, 9)) for r in range(3)]
    tms, jms = zip(*(_pair(name) for _ in range(3)))
    for tm, jm, batches in zip(tms, jms, per):
        _feed(tm, batches)
        _feed(jm, batches)
    tms[0].merge_state(tms[1:])
    jms[0].merge_state(list(jms[1:]))
    _assert_states(tms[0], jms[0])
    _assert_values(name, tms[0].compute(), jms[0].compute())
    # merging peers leaves them as they were
    _assert_states(tms[2], jms[2])


def test_empty_peer_and_empty_metric_merge():
    tm, jm = _pair("binary_auprc")
    _feed(tm, _batches("binary_auprc", 3))
    _feed(jm, _batches("binary_auprc", 3))
    tm.merge_state([TM.BinaryAUPRC(device=CPU)])
    jm.merge_state([JM.BinaryAUPRC()])
    _assert_states(tm, jm)
    empty_t, empty_j = _pair("binary_auprc")
    empty_t.merge_state([tm])
    empty_j.merge_state([jm])
    _assert_states(empty_t, empty_j)


def test_compute_without_data_raises():
    with pytest.raises(RuntimeError, match="no data"):
        TM.BinaryAUROC(device=CPU).compute()


def test_64_bit_inputs_narrow_to_jax_state_dtypes():
    tm, jm = _pair("multiclass_auroc")
    rng = np.random.default_rng(4)
    x = rng.random((40, C))  # float64
    y = rng.integers(0, C, 40)  # int64
    tm.update(torch.from_numpy(x), torch.from_numpy(y))
    jm.update(x, y)
    assert tm.inputs.dtype == torch.float32 and tm.targets.dtype == torch.int32
    _assert_states(tm, jm)


def test_reset_returns_to_the_sentinel():
    tm, _ = _pair("binary_auroc_tasks")
    _feed(tm, _batches("binary_auroc_tasks", 5))
    tm.reset()
    assert tm.num_samples == 0 and tm.inputs.shape == (0,) and tm.inputs.dtype == torch.float32
    _feed(tm, _batches("binary_auroc_tasks", 5))
    assert tm.inputs.shape == (2, 256)


def test_bad_batch_changes_nothing():
    tm = TM.BinaryAUROC(device=CPU)
    _feed(tm, _batches("binary_auroc", 6, sizes=(10,)))
    before = tm.state_dict()
    with pytest.raises(ValueError):
        tm.update(torch.rand(5), torch.ones(4))
    for k, v in before.items():
        assert torch.equal(v, getattr(tm, k)) if isinstance(v, torch.Tensor) else v == getattr(tm, k)


def test_state_dict_does_not_alias_the_buffers():
    tm = TM.BinaryAUPRC(device=CPU)
    _feed(tm, _batches("binary_auprc", 7, sizes=(10,)))
    sd = tm.state_dict()
    _feed(tm, _batches("binary_auprc", 8, sizes=(10,)))  # writes in place
    assert sd["_num_samples"] == 10 and torch.isinf(sd["inputs"][10:]).all()
    clone = TM.BinaryAUPRC(device=CPU)
    clone.load_state_dict(sd)
    sd["inputs"].fill_(0.5)
    assert torch.isinf(clone.inputs[10:]).all()


def test_pickle_round_trip_keeps_updating():
    tm, jm = _pair("multilabel_prc")
    batches = _batches("multilabel_prc", 9)
    _feed(tm, batches[:2])
    tm = pickle.loads(pickle.dumps(tm))
    _feed(tm, batches[2:])
    _feed(jm, batches)
    _assert_states(tm, jm)


def test_update_collection_runs_buffered_metrics():
    batches = _batches("binary_auroc", 11)
    tcoll = {"auroc": TM.BinaryAUROC(device=CPU), "auprc": TM.BinaryAUPRC(device=CPU)}
    jcoll = {"auroc": JM.BinaryAUROC(), "auprc": JM.BinaryAUPRC()}
    for args, _ in batches:
        ttoolkit.update_collection(tcoll, *args)
        jtoolkit.update_collection(jcoll, *args)
    for name in tcoll:
        _assert_states(tcoll[name], jcoll[name])


# ------------------------------------------------------------- sync trimming


@pytest.mark.parametrize("name", ["binary_auroc_tasks", "multiclass_auroc", "binary_prc"])
def test_sync_state_dict_trims_to_the_valid_bucket(name):
    tm, jm = _pair(name)
    batches = _batches(name, 12, sizes=(300, 40))
    _feed(tm, batches)
    _feed(jm, batches)
    # an over-provisioned metric: 100 valid samples in a 512-slot buffer
    big = {k: v for k, v in jm.state_dict().items()}
    big["_num_samples"] = 100
    for buf, spec in jm._buffer_specs.items():
        arr = np.array(big[buf])
        axis = spec.axis % arr.ndim
        idx = [slice(None)] * arr.ndim
        idx[axis] = slice(100, None)
        arr[tuple(idx)] = spec.fill
        big[buf] = arr
    jm.load_state_dict({k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in big.items()})
    load_numpy_state_dict(tm, big)
    want = jm._sync_state_dict()
    got = tm._sync_state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, int):
            assert got[k] == v
        else:
            assert got[k].shape == np.asarray(v).shape == tuple(
                128 if d == 512 else d for d in np.asarray(big[k]).shape)
            assert got[k].numpy().tobytes() == np.asarray(v).tobytes()
    # a clone loaded from the trimmed state computes as the original
    clone = CASES[name][0](TM, device=CPU)
    clone.load_state_dict(got)
    _assert_values(name, clone.compute(), tm.compute())


def test_local_replica_sync_of_buffered_metrics_matches_jax():
    names = ["binary_auroc", "binary_auprc", "multiclass_auroc", "multilabel_prc", "binary_rafp"]
    treps = [{n: CASES[n][0](TM, device=CPU) for n in names} for _ in range(3)]
    jreps = [{n: CASES[n][0](JM) for n in names} for _ in range(3)]
    for r in range(3):
        for n in names:
            batches = _batches(n, 20 + r, sizes=(10 + 60 * r,))
            _feed(treps[r][n], batches)
            _feed(jreps[r][n], batches)
    tgroup = tdist.LocalReplicaGroup([torch.device(CPU)] * 3)
    jgroup = jdist.LocalReplicaGroup(jax.devices("cpu")[:3])
    tsynced = ttoolkit.get_synced_metric_collection(treps, tgroup)
    jsynced = jtoolkit.get_synced_metric_collection(jreps, jgroup)
    for n in names:
        _assert_states(tsynced[n], jsynced[n])
        _assert_values(n, tsynced[n].compute(), jsynced[n].compute())


# -------------------------------------------------- state_dict across packages


def _to_jax(sd):
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in sd.items()}


@pytest.mark.parametrize("grown", [False, True], ids=["empty", "grown"])
@pytest.mark.parametrize("name", NAMES)
def test_state_dict_cross_loads_jax_port_jax(name, grown):
    batches = _batches(name, 30, sizes=(40, 90)) if grown else []
    jm = _feed(CASES[name][0](JM), batches)
    tm = CASES[name][0](TM, device=CPU)
    load_numpy_state_dict(tm, {k: np.asarray(v) for k, v in jm.state_dict().items()})
    _assert_states(tm, jm)
    back = CASES[name][0](JM)
    back.load_state_dict(_to_jax(numpy_state_dict(tm)))
    _assert_states(tm, back)
    assert isinstance(tm.num_samples, int) and isinstance(back._num_samples, int)
    # both keep updating alike from the carried state
    more = _batches(name, 31, sizes=(25,))
    _feed(tm, more)
    _feed(back, more)
    _assert_states(tm, back)
    _assert_values(name, tm.compute(), back.compute())
