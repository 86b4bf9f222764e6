"""torcheval_tpu_torch accuracy and F1 (functional and class) against the
JAX package on the same numpy inputs. Counters must be bitwise equal;
computed values are equal up to float32 summation order (rtol 1e-6) where
a mean over classes is taken."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as JM
import torcheval_tpu.metrics.functional as JF
from torcheval_tpu.metrics import toolkit as jtoolkit
import torcheval_tpu_torch.metrics as TM
import torcheval_tpu_torch.metrics.functional as TF
from torcheval_tpu_torch.metrics import toolkit as ttoolkit

CPU = "cpu"
C = 12


def _logits(seed, n=300, c=C, tricky=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, c)).astype(np.float32)
    y = rng.integers(0, c, n)
    if tricky:
        x[0] = 0.5  # all tied
        x[1, 4] = np.nan
        x[2, :] = -1.0
        x[2, 3] = -0.0
        x[2, 7] = 0.0
        x[3, 5] = np.inf
        x[4:20:3] = np.round(x[4:20:3])  # many ties
        y[5:9] = [c, c + 3, -1, -2]  # out-of-range targets
    return x, y


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _same_counters(tm, jm, names):
    for name in names:
        np.testing.assert_array_equal(_np(getattr(tm, name)), np.asarray(getattr(jm, name)))


AVERAGES = ["micro", "macro", "none", None]


@pytest.mark.parametrize("average", AVERAGES)
@pytest.mark.parametrize("input_kind", ["logits", "labels"])
def test_multiclass_accuracy_class_matches_jax(average, input_kind):
    x, y = _logits(1)
    if input_kind == "labels":
        x = np.random.default_rng(2).integers(0, C, x.shape[0])
    kw = {} if average == "micro" else {"num_classes": C}
    tm = TM.MulticlassAccuracy(average=average, device=CPU, **kw)
    jm = JM.MulticlassAccuracy(average=average, **kw)
    for lo in range(0, len(y), 100):
        tm.update(x[lo:lo + 100], y[lo:lo + 100])
        jm.update(x[lo:lo + 100], y[lo:lo + 100])
    _same_counters(tm, jm, ("num_correct", "num_total"))
    np.testing.assert_allclose(_np(tm.compute()), np.asarray(jm.compute()), rtol=1e-6)


@pytest.mark.parametrize("k", [2, 3])
def test_topk_accuracy_matches_jax(k):
    x, y = _logits(3, tricky=False)
    y[:3] = [C, -1, C + 1]  # out of range: the JAX gather fills NaN
    for average in ("micro", "macro"):
        kw = {} if average == "micro" else {"num_classes": C}
        tm = TM.MulticlassAccuracy(average=average, k=k, device=CPU, **kw).update(x, y)
        jm = JM.MulticlassAccuracy(average=average, k=k, **kw).update(x, y)
        _same_counters(tm, jm, ("num_correct", "num_total"))


@pytest.mark.parametrize("average", ["micro", "macro", "weighted", None])
@pytest.mark.parametrize("input_kind", ["logits", "labels"])
def test_multiclass_f1_class_matches_jax(average, input_kind):
    x, y = _logits(4)
    if input_kind == "labels":
        x = np.random.default_rng(5).integers(-1, C + 1, x.shape[0])
    kw = {} if average == "micro" else {"num_classes": C}
    tm = TM.MulticlassF1Score(average=average, device=CPU, **kw)
    jm = JM.MulticlassF1Score(average=average, **kw)
    for lo in range(0, len(y), 100):
        tm.update(x[lo:lo + 100], y[lo:lo + 100])
        jm.update(x[lo:lo + 100], y[lo:lo + 100])
    _same_counters(tm, jm, ("num_tp", "num_label", "num_prediction"))
    np.testing.assert_allclose(_np(tm.compute()), np.asarray(jm.compute()), rtol=1e-6)


@pytest.mark.parametrize("threshold", [0.5, 0.3])
def test_binary_accuracy_and_f1_classes_match_jax(threshold):
    rng = np.random.default_rng(6)
    s = rng.random(500).astype(np.float32)
    s[:5] = threshold  # on the threshold -> predicted 1
    t = rng.integers(0, 2, 500)
    for T, J in ((TM.BinaryAccuracy, JM.BinaryAccuracy), (TM.BinaryF1Score, JM.BinaryF1Score)):
        tm = T(threshold=threshold, device=CPU).update(s, t)
        jm = J(threshold=threshold).update(s, t)
        names = tm._state_name_to_default
        _same_counters(tm, jm, names)
        np.testing.assert_array_equal(_np(tm.compute()), np.asarray(jm.compute()))


@pytest.mark.parametrize(
    "fn, kwargs",
    [
        ("multiclass_accuracy", {}),
        ("multiclass_accuracy", {"average": "macro", "num_classes": C}),
        ("multiclass_accuracy", {"average": None, "num_classes": C}),
        ("multiclass_accuracy", {"k": 3}),
        ("multiclass_f1_score", {}),
        ("multiclass_f1_score", {"average": "macro", "num_classes": C}),
        ("multiclass_f1_score", {"average": "weighted", "num_classes": C}),
        ("multiclass_f1_score", {"average": None, "num_classes": C}),
    ],
)
def test_multiclass_functional_matches_jax(fn, kwargs):
    x, y = _logits(7, tricky="k" not in kwargs)
    got = getattr(TF, fn)(torch.from_numpy(x), torch.from_numpy(y), **kwargs)
    want = getattr(JF, fn)(x, y, **kwargs)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("fn", ["binary_accuracy", "binary_f1_score"])
def test_binary_functional_matches_jax(fn):
    rng = np.random.default_rng(8)
    s = rng.random(400).astype(np.float32)
    t = rng.integers(0, 2, 400)
    got = getattr(TF, fn)(s, t, threshold=0.4, device=CPU)
    want = getattr(JF, fn)(s, t, threshold=0.4)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_functional_runs_where_its_tensors_live():
    x, y = _logits(9, tricky=False)
    out = TF.multiclass_accuracy(torch.from_numpy(x), torch.from_numpy(y))
    assert out.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            TF.multiclass_accuracy(x, y)  # numpy inputs go to CUDA by default


@pytest.mark.parametrize(
    "make, error",
    [
        (lambda P, **k: P.MulticlassAccuracy(average="weird", **k), ValueError),
        (lambda P, **k: P.MulticlassAccuracy(average="macro", **k), ValueError),
        (lambda P, **k: P.MulticlassAccuracy(k=0, **k), ValueError),
        (lambda P, **k: P.MulticlassAccuracy(k=1.5, **k), TypeError),
        (lambda P, **k: P.MulticlassF1Score(average="none", num_classes=3, **k), ValueError),
        (lambda P, **k: P.MulticlassF1Score(average=None, **k), ValueError),
    ],
)
def test_param_checks_match_jax(make, error):
    with pytest.raises(error):
        make(JM)
    with pytest.raises(error):
        make(TM, device=CPU)


@pytest.mark.parametrize(
    "x_shape, y_shape",
    [((10, C), (9,)), ((10, C), (10, 1)), ((10, C + 1), (10,)), ((10, C, 2), (10,))],
)
def test_input_checks_match_jax(x_shape, y_shape):
    x = np.zeros(x_shape, np.float32)
    y = np.zeros(y_shape, np.int64)
    for P, kw in ((JM, {}), (TM, {"device": CPU})):
        for m in (
            P.MulticlassAccuracy(average="macro", num_classes=C, **kw),
            P.MulticlassF1Score(average="macro", num_classes=C, **kw),
        ):
            with pytest.raises(ValueError):
                m.update(x, y)


@pytest.mark.parametrize("weight", [1.0, 0.5, 3, "tensor"])
@pytest.mark.parametrize("name", ["Mean", "Sum"])
def test_aggregation_matches_jax(name, weight):
    rng = np.random.default_rng(10)
    batches = [rng.standard_normal(50).astype(np.float32) for _ in range(3)]
    tm, jm = getattr(TM, name)(device=CPU), getattr(JM, name)()
    for b in batches:
        w = rng.random(50).astype(np.float32) if weight == "tensor" else weight
        tm.update(b, weight=w)
        jm.update(b, weight=w)
    np.testing.assert_allclose(_np(tm.compute()), np.asarray(jm.compute()), rtol=1e-6)
    want = getattr(JF, name.lower())(batches[0], 0.5)
    got = getattr(TF, name.lower())(batches[0], 0.5, device=CPU)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6)


def test_update_collection_matches_jax_and_is_all_or_nothing():
    x, y = _logits(11)
    tcoll = {
        "acc": TM.MulticlassAccuracy(device=CPU),
        "acc_macro": TM.MulticlassAccuracy(average="macro", num_classes=C, device=CPU),
        "f1": TM.MulticlassF1Score(average="macro", num_classes=C, device=CPU),
    }
    jcoll = {
        "acc": JM.MulticlassAccuracy(),
        "acc_macro": JM.MulticlassAccuracy(average="macro", num_classes=C),
        "f1": JM.MulticlassF1Score(average="macro", num_classes=C),
    }
    for lo in range(0, len(y), 75):
        ttoolkit.update_collection(tcoll, x[lo:lo + 75], y[lo:lo + 75])
        jtoolkit.update_collection(jcoll, x[lo:lo + 75], y[lo:lo + 75])
    for name in tcoll:
        _same_counters(tcoll[name], jcoll[name], tcoll[name]._state_name_to_default)
        np.testing.assert_allclose(
            _np(tcoll[name].compute()), np.asarray(jcoll[name].compute()), rtol=1e-6
        )
    before = {n: m.state_dict() for n, m in tcoll.items()}
    with pytest.raises(ValueError):  # wrong class count: rejected by a plan
        ttoolkit.update_collection(tcoll, x[:, :5], y)
    for name, m in tcoll.items():
        for state, value in m.state_dict().items():
            assert torch.equal(value, before[name][state])


def test_reset_then_reuse_matches_fresh_metric():
    x, y = _logits(12)
    m = TM.MulticlassF1Score(average="macro", num_classes=C, device=CPU).update(x, y)
    m.reset().update(x[:50], y[:50])
    fresh = TM.MulticlassF1Score(average="macro", num_classes=C, device=CPU).update(x[:50], y[:50])
    assert torch.equal(m.compute(), fresh.compute())


def test_merge_state_matches_jax():
    x, y = _logits(13)
    t = [TM.MulticlassAccuracy(average=None, num_classes=C, device=CPU).update(x[i::3], y[i::3]) for i in range(3)]
    j = [JM.MulticlassAccuracy(average=None, num_classes=C).update(x[i::3], y[i::3]) for i in range(3)]
    t[0].merge_state(t[1:])
    j[0].merge_state(j[1:])
    _same_counters(t[0], j[0], ("num_correct", "num_total"))
