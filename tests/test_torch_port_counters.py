"""torcheval_tpu_torch's counter families -- confusion matrix, precision,
recall, multilabel and top-k multilabel accuracy -- against the JAX
package on the same numpy inputs: functional forms over every
``average``/``normalize``/``criteria``, and the classes through update,
compute, reset, ``merge_state``, a ``state_dict`` cross-load both ways and
a ``LocalReplicaGroup`` sync.

Tolerances: counter states (int32 matrices, integer-valued float32
counts) are bitwise equal; rates agree within rtol 1e-6 (a mean over
classes may sum in another order).
"""

from __future__ import annotations

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
C = 9  # classes
L = 7  # labels


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype.kind in "iub":
        assert got.tobytes() == want.tobytes()
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)


def _logits(seed, n=240, tricky=True):
    """Logits with ties, NaN, +-0 and +-inf, and targets including some
    outside ``[0, C)``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, C)).astype(np.float32)
    y = rng.integers(0, C, n)
    if tricky:
        x[0] = 0.5
        x[1, 4] = np.nan
        x[2, :] = -1.0
        x[2, 3], x[2, 7] = -0.0, 0.0
        x[3, 5] = np.inf
        x[4:40:3] = np.round(x[4:40:3])
        y[5:9] = [C, C + 3, -1, -2]
    return x, y


def _labels(seed, n=240):
    """Predicted labels (some outside ``[0, C)``) and targets."""
    rng = np.random.default_rng(seed)
    return rng.integers(-1, C + 1, n), rng.integers(0, C, n)


def _binary(seed, n=300, threshold=0.5):
    rng = np.random.default_rng(seed)
    s = rng.random(n).astype(np.float32)
    s[:4] = threshold  # on the threshold: predicted positive
    s[4] = np.nan
    return s, rng.integers(0, 2, n)


def _multilabel(seed, n=200, ties=False):
    rng = np.random.default_rng(seed)
    s = rng.random((n, L)).astype(np.float32)
    if ties:
        s = np.round(s * 4) / 4
        s[0] = 0.25  # a whole row tied
        s[1, 2], s[1, 5] = np.nan, -np.nan
        s[2, 1], s[2, 4] = -0.0, 0.0
        s[3, 0] = np.inf
    t = (rng.random((n, L)) < 0.3).astype(np.int64)
    t[::17] = 0  # all-negative rows
    return s, t


# ------------------------------------------------------------- functional


NORMALIZE = [None, "none", "pred", "true", "all"]


@pytest.mark.parametrize("normalize", NORMALIZE)
@pytest.mark.parametrize("kind", ["logits", "labels"])
def test_multiclass_confusion_matrix_matches_jax(kind, normalize):
    x, y = _logits(1) if kind == "logits" else _labels(2)
    got = TF.multiclass_confusion_matrix(x, y, num_classes=C, normalize=normalize, device=CPU)
    _close(got, JF.multiclass_confusion_matrix(x, y, num_classes=C, normalize=normalize))


@pytest.mark.parametrize("normalize", NORMALIZE)
@pytest.mark.parametrize("threshold", [0.5, 0.25])
def test_binary_confusion_matrix_matches_jax(threshold, normalize):
    s, t = _binary(3, threshold=threshold)
    got = TF.binary_confusion_matrix(s, t, threshold=threshold, normalize=normalize, device=CPU)
    _close(got, JF.binary_confusion_matrix(s, t, threshold=threshold, normalize=normalize))


AVERAGES = ["micro", "macro", "weighted", None]


@pytest.mark.parametrize("average", AVERAGES)
@pytest.mark.parametrize("kind", ["logits", "labels"])
@pytest.mark.parametrize("name", ["multiclass_precision", "multiclass_recall"])
def test_multiclass_precision_recall_match_jax(name, kind, average):
    x, y = _logits(4) if kind == "logits" else _labels(5)
    kw = {} if average == "micro" else {"num_classes": C}
    got = getattr(TF, name)(x, y, average=average, device=CPU, **kw)
    _close(got, getattr(JF, name)(x, y, average=average, **kw))


def test_absent_class_macro_matches_jax():
    """A class absent from both labels and predictions is left out of the
    macro mean; one only predicted counts with precision 0 / recall 0."""
    pred = np.array([0, 0, 1, 3, 3])
    target = np.array([0, 1, 1, 1, 0])
    for name in ("multiclass_precision", "multiclass_recall"):
        for average in ("macro", "weighted", None):
            got = getattr(TF, name)(pred, target, num_classes=5, average=average, device=CPU)
            _close(got, getattr(JF, name)(pred, target, num_classes=5, average=average))


@pytest.mark.parametrize("threshold", [0.5, 0.7])
@pytest.mark.parametrize("name", ["binary_precision", "binary_recall"])
def test_binary_precision_recall_match_jax(name, threshold):
    s, t = _binary(6, threshold=threshold)
    _close(getattr(TF, name)(s, t, threshold=threshold, device=CPU),
           getattr(JF, name)(s, t, threshold=threshold))
    zero = np.zeros(5, np.float32)  # no positive prediction, no positive label
    _close(getattr(TF, name)(zero, zero.astype(np.int64), device=CPU),
           getattr(JF, name)(zero, zero.astype(np.int64)))


CRITERIA = ["exact_match", "hamming", "overlap", "contain", "belong"]


@pytest.mark.parametrize("threshold", [0.5, 0.3])
@pytest.mark.parametrize("criteria", CRITERIA)
def test_multilabel_accuracy_matches_jax(criteria, threshold):
    s, t = _multilabel(7, ties=True)
    got = TF.multilabel_accuracy(s, t, threshold=threshold, criteria=criteria, device=CPU)
    _close(got, JF.multilabel_accuracy(s, t, threshold=threshold, criteria=criteria))


@pytest.mark.parametrize("k", [2, 3, L])
@pytest.mark.parametrize("criteria", CRITERIA)
def test_topk_multilabel_accuracy_matches_jax(criteria, k):
    s, t = _multilabel(8, ties=True)
    got = TF.topk_multilabel_accuracy(s, t, criteria=criteria, k=k, device=CPU)
    _close(got, JF.topk_multilabel_accuracy(s, t, criteria=criteria, k=k))


@pytest.mark.parametrize("call", [
    lambda F, **d: F.multiclass_confusion_matrix([0, 1], [0, 1], num_classes=1, **d),
    lambda F, **d: F.multiclass_confusion_matrix([0, 1], [0, 1], num_classes=2, normalize="x", **d),
    lambda F, **d: F.multiclass_confusion_matrix([[0.1, 0.9]], [0, 1], num_classes=2, **d),
    lambda F, **d: F.binary_confusion_matrix([[0.1]], [[1]], **d),
    lambda F, **d: F.multiclass_precision([0, 1], [0, 1], average="macro", **d),
    lambda F, **d: F.multiclass_recall([0, 1], [0, 1], average="bad", **d),
    lambda F, **d: F.multiclass_recall([[0, 1]], [[0, 1]], **d),
    lambda F, **d: F.binary_precision([0.1, 0.2], [1], **d),
    lambda F, **d: F.multilabel_accuracy([[0.1, 0.2]], [[1, 0]], criteria="nope", **d),
    lambda F, **d: F.multilabel_accuracy([[0.1, 0.2]], [[1, 0, 1]], **d),
    lambda F, **d: F.topk_multilabel_accuracy([[0.1, 0.2]], [[1, 0]], k=1, **d),
    lambda F, **d: F.topk_multilabel_accuracy([[0.1, 0.2]], [[1, 0]], k=3, **d),
    lambda F, **d: F.topk_multilabel_accuracy([0.1, 0.2], [1, 0], k=2, **d),
])
def test_bad_arguments_raise_like_jax(call):
    with pytest.raises(ValueError) as want:
        call(JF)
    with pytest.raises(ValueError) as got:
        call(TF, device=CPU)
    assert str(got.value).split(",")[0] == str(want.value).split(",")[0]


def test_topk_k_type_raises_like_jax():
    for F, d in ((JF, {}), (TF, {"device": CPU})):
        with pytest.raises(TypeError):
            F.topk_multilabel_accuracy([[0.1, 0.2, 0.3]], [[1, 0, 1]], k=2.0, **d)


# ------------------------------------------------------------------ classes


def _logit_batches(seed):
    return [_logits(seed + i, n=n, tricky=i == 0) for i, n in enumerate((90, 60, 33))]


def _label_batches(seed):
    return [_labels(seed + i, n) for i, n in enumerate((90, 60, 33))]


def _binary_batches(seed):
    return [_binary(seed + i, n) for i, n in enumerate((90, 60, 33))]


def _multilabel_batches(seed):
    return [_multilabel(seed + i, n, ties=i == 0) for i, n in enumerate((90, 60, 33))]


# name -> (constructor given the package and device kwargs, batch maker)
CASES = {
    "cm": (lambda P, **k: P.MulticlassConfusionMatrix(C, **k), _logit_batches),
    "cm_labels_true": (lambda P, **k: P.MulticlassConfusionMatrix(C, normalize="true", **k),
                       _label_batches),
    "binary_cm_all": (lambda P, **k: P.BinaryConfusionMatrix(normalize="all", **k), _binary_batches),
    "binary_cm_pred": (lambda P, **k: P.BinaryConfusionMatrix(threshold=0.3, normalize="pred", **k),
                       _binary_batches),
    "precision_micro": (lambda P, **k: P.MulticlassPrecision(**k), _logit_batches),
    "precision_macro": (lambda P, **k: P.MulticlassPrecision(num_classes=C, average="macro", **k),
                        _logit_batches),
    "precision_weighted": (lambda P, **k: P.MulticlassPrecision(
        num_classes=C, average="weighted", **k), _label_batches),
    "precision_none": (lambda P, **k: P.MulticlassPrecision(num_classes=C, average=None, **k),
                       _logit_batches),
    "binary_precision": (lambda P, **k: P.BinaryPrecision(threshold=0.4, **k), _binary_batches),
    "recall_micro": (lambda P, **k: P.MulticlassRecall(**k), _label_batches),
    "recall_macro": (lambda P, **k: P.MulticlassRecall(num_classes=C, average="macro", **k),
                     _logit_batches),
    "recall_weighted": (lambda P, **k: P.MulticlassRecall(num_classes=C, average="weighted", **k),
                        _logit_batches),
    "recall_none": (lambda P, **k: P.MulticlassRecall(num_classes=C, average=None, **k),
                    _label_batches),
    "binary_recall": (lambda P, **k: P.BinaryRecall(**k), _binary_batches),
    "multilabel_exact": (lambda P, **k: P.MultilabelAccuracy(**k), _multilabel_batches),
    "multilabel_hamming": (lambda P, **k: P.MultilabelAccuracy(criteria="hamming", **k),
                           _multilabel_batches),
    "multilabel_overlap": (lambda P, **k: P.MultilabelAccuracy(
        threshold=0.3, criteria="overlap", **k), _multilabel_batches),
    "multilabel_contain": (lambda P, **k: P.MultilabelAccuracy(criteria="contain", **k),
                           _multilabel_batches),
    "multilabel_belong": (lambda P, **k: P.MultilabelAccuracy(criteria="belong", **k),
                          _multilabel_batches),
    "topk_hamming": (lambda P, **k: P.TopKMultilabelAccuracy(criteria="hamming", k=3, **k),
                     _multilabel_batches),
    "topk_overlap": (lambda P, **k: P.TopKMultilabelAccuracy(criteria="overlap", k=2, **k),
                     _multilabel_batches),
    "topk_contain": (lambda P, **k: P.TopKMultilabelAccuracy(criteria="contain", k=4, **k),
                     _multilabel_batches),
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
        ours, theirs = getattr(tm, name).numpy(), np.asarray(value)
        assert ours.dtype == theirs.dtype and ours.shape == theirs.shape, name
        assert ours.tobytes() == theirs.tobytes(), name


@pytest.mark.parametrize("name", NAMES)
def test_class_update_compute_reset_matches_jax(name):
    make, batches = CASES[name]
    tm, jm = make(TM, device=CPU), make(JM)
    _assert_states(tm, jm)
    _feed(tm, batches(10))
    _feed(jm, batches(10))
    _assert_states(tm, jm)
    _close(tm.compute(), jm.compute())
    _close(tm.compute(), jm.compute())  # idempotent
    tm.reset()
    jm.reset()
    _assert_states(tm, jm)
    _feed(tm, batches(20)[:1])
    _feed(jm, batches(20)[:1])
    _close(tm.compute(), jm.compute())


@pytest.mark.parametrize("name", NAMES)
def test_class_merge_state_matches_jax_and_one_stream(name):
    make, batches = CASES[name]
    stream = batches(30)
    tms = [_feed(make(TM, device=CPU), [b]) for b in stream]
    jms = [_feed(make(JM), [b]) for b in stream]
    tms[0].merge_state(tms[1:])
    jms[0].merge_state(jms[1:])
    _assert_states(tms[0], jms[0])
    one = _feed(make(TM, device=CPU), stream)
    for state in one.state_dict():
        assert torch.equal(getattr(one, state), getattr(tms[0], state)), state
    _close(tms[0].compute(), jms[0].compute())


def _to_jax(sd):
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in sd.items()}


@pytest.mark.parametrize("updated", [False, True], ids=["fresh", "updated"])
@pytest.mark.parametrize("name", NAMES)
def test_state_dict_cross_loads_both_ways(name, updated):
    make, batches = CASES[name]
    jm = _feed(make(JM), batches(40) if updated else [])
    tm = make(TM, device=CPU)
    load_numpy_state_dict(tm, {k: np.asarray(v) for k, v in jm.state_dict().items()})
    _assert_states(tm, jm)
    back = make(JM)
    back.load_state_dict(_to_jax(numpy_state_dict(tm)))
    _assert_states(tm, back)
    more = batches(50)[:2]
    _feed(tm, more)
    _feed(back, more)
    _assert_states(tm, back)
    _close(tm.compute(), back.compute())


def test_local_replica_sync_of_a_collection_equals_jax_and_one_stream():
    names = ["cm", "precision_macro", "recall_weighted", "binary_cm_all", "multilabel_hamming",
             "topk_overlap"]
    world = 3
    tgroup = tdist.LocalReplicaGroup([torch.device(CPU)] * world)
    jgroup = jdist.LocalReplicaGroup(jax.devices("cpu")[:world])
    treps = [{n: CASES[n][0](TM, device=CPU) for n in names} for _ in range(world)]
    jreps = [{n: CASES[n][0](JM) for n in names} for _ in range(world)]
    single = {n: CASES[n][0](TM, device=CPU) for n in names}
    for n in names:
        for r, batch in enumerate(CASES[n][1](60)):
            for coll in (treps[r], jreps[r], single):
                coll[n].update(*batch)
    tsynced = ttoolkit.get_synced_metric_collection(treps, tgroup)
    jsynced = jtoolkit.get_synced_metric_collection(jreps, jgroup)
    for n in names:
        _assert_states(tsynced[n], jsynced[n])
        for state in single[n].state_dict():
            assert torch.equal(getattr(tsynced[n], state), getattr(single[n], state)), (n, state)
        _close(tsynced[n].compute(), jsynced[n].compute())
        assert torch.equal(tsynced[n].compute(), single[n].compute())


def test_update_collection_runs_the_new_plans():
    x, y = _logits(70)
    coll = {"cm": TM.MulticlassConfusionMatrix(C, device=CPU),
            "p": TM.MulticlassPrecision(num_classes=C, average="macro", device=CPU),
            "r": TM.MulticlassRecall(num_classes=C, average=None, device=CPU)}
    ttoolkit.update_collection(coll, x, y)
    one = TM.MulticlassConfusionMatrix(C, device=CPU).update(x, y)
    assert torch.equal(coll["cm"].confusion_matrix, one.confusion_matrix)


def test_confusion_matrix_normalized_and_dtype():
    x, y = _logits(71)
    tm = TM.MulticlassConfusionMatrix(C, device=CPU).update(x, y)
    jm = JM.MulticlassConfusionMatrix(C).update(x, y)
    assert tm.confusion_matrix.dtype == torch.int32
    for normalize in NORMALIZE:
        _close(tm.normalized(normalize), jm.normalized(normalize))


@pytest.mark.parametrize("make", [
    lambda **k: TM.MulticlassConfusionMatrix(3, **k),
    lambda **k: TM.BinaryConfusionMatrix(**k),
    lambda **k: TM.MulticlassPrecision(**k),
    lambda **k: TM.BinaryPrecision(**k),
    lambda **k: TM.MulticlassRecall(**k),
    lambda **k: TM.BinaryRecall(**k),
    lambda **k: TM.MultilabelAccuracy(**k),
    lambda **k: TM.TopKMultilabelAccuracy(**k),
])
def test_classes_default_to_cuda(make):
    """State lives on the card unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert make(device=CPU).device == torch.device(CPU)


def test_sharded_confusion_matrix_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="item A6"):
        TM.MulticlassConfusionMatrix(3, device=CPU, shard=object())
