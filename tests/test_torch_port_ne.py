"""torcheval_tpu_torch's binary normalized entropy against the JAX package
on the same numpy inputs: the functional form over probabilities and
logits, weights (zero weight included), the degenerate rates p = 0, 1 and
1.0000001, all-positive and all-negative baselines and several tasks;
the class through update, compute, reset, ``merge_state``,
``update_collection``, a ``state_dict`` cross-load both ways and a
``LocalReplicaGroup`` sync.

Tolerance: rtol 1e-6 on values and float states (XLA and torch sum in
different orders and may round a log or exp one ulp apart); integer-valued
states (example and positive counts under unit weights) bitwise.
"""

from __future__ import annotations

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


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, rtol=RTOL):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-7, equal_nan=True)


def _probs(seed, shape, edges=True):
    """Probabilities with labels drawn from them; ``edges`` plants p = 0,
    1 and 1.0000001 (an ulp past 1) beside both labels."""
    rng = np.random.default_rng(seed)
    p = rng.random(shape).astype(np.float32)
    y = (rng.random(shape) < p).astype(np.float32)
    if edges:
        flat_p, flat_y = p.reshape(-1), y.reshape(-1)
        flat_p[:6] = [0.0, 0.0, 1.0, 1.0, 1.0000001, 1.0000001]
        flat_y[:6] = [0.0, 1.0, 0.0, 1.0, 0.0, 1.0]
    return p, y


def _logits(seed, shape):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 4).astype(np.float32)
    x.reshape(-1)[:3] = [0.0, 80.0, -80.0]
    y = (rng.random(shape) < 1 / (1 + np.exp(-x))).astype(np.float32)
    return x, y


# ------------------------------------------------------------- functional


def test_probe_value_with_clamped_logs():
    """p = 0 and p = 1 on the wrong label each cost the clamped 100."""
    want = JF.binary_normalized_entropy(jnp.array([0.0, 1.0, 0.5]), jnp.array([1.0, 0.0, 1.0]))
    got = TF.binary_normalized_entropy(torch.tensor([0.0, 1.0, 0.5]), torch.tensor([1.0, 0.0, 1.0]))
    _close(got, want)
    np.testing.assert_allclose(float(got), 105.10012, rtol=1e-6)


@pytest.mark.parametrize("weighted", [False, True], ids=["unit", "weighted"])
@pytest.mark.parametrize("num_tasks", [1, 3])
def test_probabilities_match_jax(num_tasks, weighted):
    shape = (500,) if num_tasks == 1 else (num_tasks, 500)
    p, y = _probs(num_tasks, shape)
    w = np.random.default_rng(7).random(shape).astype(np.float32) if weighted else None
    got = TF.binary_normalized_entropy(p, y, weight=w, num_tasks=num_tasks, device=CPU)
    want = JF.binary_normalized_entropy(p, y, weight=w, num_tasks=num_tasks)
    _close(got, want)


@pytest.mark.parametrize("weighted", [False, True], ids=["unit", "weighted"])
@pytest.mark.parametrize("num_tasks", [1, 2])
def test_logits_match_jax(num_tasks, weighted):
    shape = (400,) if num_tasks == 1 else (num_tasks, 400)
    x, y = _logits(10 + num_tasks, shape)
    w = np.random.default_rng(8).random(shape).astype(np.float32) if weighted else None
    got = TF.binary_normalized_entropy(x, y, weight=w, num_tasks=num_tasks, from_logits=True,
                                       device=CPU)
    want = JF.binary_normalized_entropy(x, y, weight=w, num_tasks=num_tasks, from_logits=True)
    _close(got, want)


@pytest.mark.parametrize("label", [0.0, 1.0], ids=["all_negative", "all_positive"])
@pytest.mark.parametrize("from_logits", [False, True], ids=["probs", "logits"])
def test_degenerate_baselines_stay_finite_and_match(label, from_logits):
    """A rate of exactly 0 or 1: the float64-eps clamp keeps the baseline
    finite in both tails."""
    rng = np.random.default_rng(3)
    x = rng.random(64).astype(np.float32)
    if from_logits:
        x = x * 6 - 3
    y = np.full(64, label, dtype=np.float32)
    got = TF.binary_normalized_entropy(x, y, from_logits=from_logits, device=CPU)
    want = JF.binary_normalized_entropy(x, y, from_logits=from_logits)
    assert np.isfinite(_np(got))
    _close(got, want)


@pytest.mark.parametrize("which", ["all", "some"])
def test_zero_weight_matches_jax(which):
    p, y = _probs(4, (2, 50))
    w = np.ones((2, 50), np.float32)
    if which == "all":
        w[1] = 0.0  # task 1 has no weight: 0/0, NaN in both packages
    else:
        w[:, ::3] = 0.0
    got = TF.binary_normalized_entropy(p, y, weight=w, num_tasks=2, device=CPU)
    want = JF.binary_normalized_entropy(p, y, weight=w, num_tasks=2)
    _close(got, want)
    if which == "all":
        assert np.isnan(_np(got)[1]) and np.isfinite(_np(got)[0])


def test_ce_rows_and_baseline_match_jax():
    """The per-element cross entropy and the baseline on their own."""
    # the packages re-export the function under the module's name
    jne = importlib.import_module(
        "torcheval_tpu.metrics.functional.classification.binary_normalized_entropy")
    tne = importlib.import_module(
        "torcheval_tpu_torch.metrics.functional.classification.binary_normalized_entropy")

    p, y = _probs(5, (300,))
    for from_logits in (False, True):
        got, _ = tne._ne_ce_rows(torch.from_numpy(p), torch.from_numpy(y), from_logits)
        want, _ = jne._ne_ce_rows(jnp.asarray(p), jnp.asarray(y), from_logits)
        _close(got, want)
    npos = np.array([0.0, 1.0, 5.0, 99.0, 100.0, 0.0], np.float32)
    nex = np.array([100.0, 100.0, 100.0, 100.0, 100.0, 0.0], np.float32)
    _close(tne._baseline_update(torch.from_numpy(npos), torch.from_numpy(nex)),
           jne._baseline_update(jnp.asarray(npos), jnp.asarray(nex)))


@pytest.mark.parametrize("call", [
    lambda F, **k: F.binary_normalized_entropy(np.zeros((2, 3)), np.zeros(3), **k),
    lambda F, **k: F.binary_normalized_entropy(np.zeros(3), np.zeros(3), weight=np.ones(2), **k),
    lambda F, **k: F.binary_normalized_entropy(np.zeros((2, 3)), np.zeros((2, 3)), **k),
    lambda F, **k: F.binary_normalized_entropy(np.zeros(3), np.zeros(3), num_tasks=2, **k),
    lambda F, **k: F.binary_normalized_entropy(np.zeros((3, 4)), np.zeros((3, 4)), num_tasks=2,
                                               **k),
])
def test_bad_shapes_raise_like_jax(call):
    with pytest.raises(ValueError) as theirs:
        call(JF)
    with pytest.raises(ValueError) as ours:
        call(TF, device=CPU)
    assert str(ours.value).split("(")[0] == str(theirs.value).split("(")[0]


# ------------------------------------------------------------------ class


def _batches(seed, num_tasks, weighted, from_logits):
    out = []
    for i, n in enumerate((90, 60, 33)):
        shape = (n,) if num_tasks == 1 else (num_tasks, n)
        x, y = _logits(seed + i, shape) if from_logits else _probs(seed + i, shape, edges=i == 0)
        w = np.random.default_rng(seed + 50 + i).random(shape).astype(np.float32) if weighted else None
        out.append((x, y, w))
    return out


CASES = {
    "probs": dict(num_tasks=1, weighted=False, from_logits=False),
    "probs_weighted": dict(num_tasks=1, weighted=True, from_logits=False),
    "logits_tasks": dict(num_tasks=3, weighted=False, from_logits=True),
    "logits_tasks_weighted": dict(num_tasks=3, weighted=True, from_logits=True),
}


def _make(P, case, **kw):
    c = CASES[case]
    return P.BinaryNormalizedEntropy(from_logits=c["from_logits"], num_tasks=c["num_tasks"], **kw)


def _feed(metric, batches):
    for x, y, w in batches:
        metric.update(x, y, weight=w)
    return metric


def _batches_for(case, seed):
    c = CASES[case]
    return _batches(seed, c["num_tasks"], c["weighted"], c["from_logits"])


def _assert_states(tm, jm, exact_counts):
    jsd = jm.state_dict()
    assert sorted(tm.state_dict()) == sorted(jsd)
    for name, value in jsd.items():
        ours, theirs = getattr(tm, name).numpy(), np.asarray(value)
        assert ours.dtype == theirs.dtype == np.float32 and ours.shape == theirs.shape, name
        if exact_counts and name != "total_entropy":
            assert ours.tobytes() == theirs.tobytes(), name
        else:
            np.testing.assert_allclose(ours, theirs, rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_class_update_compute_reset_matches_jax(case):
    tm, jm = _make(TM, case, device=CPU), _make(JM, case)
    exact = not CASES[case]["weighted"]
    _assert_states(tm, jm, True)
    _feed(tm, _batches_for(case, 10))
    _feed(jm, _batches_for(case, 10))
    _assert_states(tm, jm, exact)
    _close(tm.compute(), jm.compute())
    _close(tm.compute(), jm.compute())  # idempotent
    tm.reset()
    jm.reset()
    _assert_states(tm, jm, True)
    _feed(tm, _batches_for(case, 20)[:1])
    _feed(jm, _batches_for(case, 20)[:1])
    _close(tm.compute(), jm.compute())


@pytest.mark.parametrize("case", sorted(CASES))
def test_class_merge_state_matches_jax_and_one_stream(case):
    stream = _batches_for(case, 30)
    tms = [_feed(_make(TM, case, device=CPU), [b]) for b in stream]
    jms = [_feed(_make(JM, case), [b]) for b in stream]
    tms[0].merge_state(tms[1:])
    jms[0].merge_state(jms[1:])
    _assert_states(tms[0], jms[0], not CASES[case]["weighted"])
    one = _feed(_make(TM, case, device=CPU), stream)
    for state in ("num_examples", "num_positive", "total_entropy"):
        np.testing.assert_allclose(getattr(one, state).numpy(), getattr(tms[0], state).numpy(),
                                   rtol=RTOL)
    _close(tms[0].compute(), jms[0].compute())


def _to_jax(sd):
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in sd.items()}


@pytest.mark.parametrize("updated", [False, True], ids=["fresh", "updated"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_state_dict_cross_loads_both_ways(case, updated):
    jm = _feed(_make(JM, case), _batches_for(case, 40) if updated else [])
    tm = _make(TM, case, device=CPU)
    load_numpy_state_dict(tm, {k: np.asarray(v) for k, v in jm.state_dict().items()})
    _assert_states(tm, jm, True)
    back = _make(JM, case)
    back.load_state_dict(_to_jax(numpy_state_dict(tm)))
    _assert_states(tm, back, True)
    more = _batches_for(case, 50)[:2]
    _feed(tm, more)
    _feed(back, more)
    _assert_states(tm, back, not CASES[case]["weighted"])
    _close(tm.compute(), back.compute())


def test_update_collection_and_local_replica_sync_match_jax():
    world = 3
    tgroup = tdist.LocalReplicaGroup([torch.device(CPU)] * world)
    jgroup = jdist.LocalReplicaGroup(jax.devices("cpu")[:world])
    treps = [{"ne": TM.BinaryNormalizedEntropy(device=CPU)} for _ in range(world)]
    jreps = [{"ne": JM.BinaryNormalizedEntropy()} for _ in range(world)]
    for r, (x, y, _) in enumerate(_batches(60, 1, False, False)):
        ttoolkit.update_collection(treps[r], x, y)
        jtoolkit.update_collection(jreps[r], x, y)
    tsynced = ttoolkit.get_synced_metric_collection(treps, tgroup)
    jsynced = jtoolkit.get_synced_metric_collection(jreps, jgroup)
    _assert_states(tsynced["ne"], jsynced["ne"], True)
    _close(tsynced["ne"].compute(), jsynced["ne"].compute())


def test_float64_inputs_keep_float32_state():
    """64-bit inputs narrow as the JAX package's arrays hold them: no
    float64 state."""
    p, y = _probs(70, (40,))
    tm = TM.BinaryNormalizedEntropy(device=CPU).update(
        torch.from_numpy(p.astype(np.float64)), torch.from_numpy(y.astype(np.float64)),
        weight=torch.ones(40, dtype=torch.float64))
    assert all(getattr(tm, s).dtype == torch.float32 for s in tm.state_dict())
    _close(tm.compute(), JM.BinaryNormalizedEntropy().update(p, y).compute())


def test_num_tasks_below_one_raises_like_jax():
    with pytest.raises(ValueError, match="num_tasks"):
        JM.BinaryNormalizedEntropy(num_tasks=0)
    with pytest.raises(ValueError, match="num_tasks"):
        TM.BinaryNormalizedEntropy(num_tasks=0, device=CPU)


def test_class_defaults_to_cuda():
    if torch.cuda.is_available():
        assert TM.BinaryNormalizedEntropy().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TM.BinaryNormalizedEntropy()
