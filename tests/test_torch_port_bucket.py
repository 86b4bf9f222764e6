"""torcheval_tpu_torch's shape bucketing against the JAX package's.

- ``bucket_length`` / ``bucket_bound`` equal the JAX functions;
- ``apply_bucketing`` rewrites a plan as the JAX one does: the same padded
  shapes, zero padding, the masked kernel even for a bucket-sized batch,
  the int32 valid vector in order of first label appearance, the same
  ``ValueError`` on mismatched label sizes;
- every ported mask-aware twin equals its JAX twin on the same padded
  inputs and valid vector (numpy arrays from a seed);
- every bucket-aware class's bucketed ragged stream equals its unbucketed
  stream and the JAX package's bucketed stream;
- the ``shape_bucketing`` knob: default, env spelling, independence.

Tolerances: counters (integer-valued float32 or int32 states and outputs)
bitwise; float sums within rtol 1e-6 (the tolerance of the regression and
text port tests: the same sums in another order).
"""

from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torcheval_tpu.config as jconfig
import torcheval_tpu.metrics as JM
import torcheval_tpu_torch.config as tconfig
import torcheval_tpu_torch.metrics as TM
from torcheval_tpu.metrics import _bucket as jbucket
from torcheval_tpu.metrics.metric import UpdatePlan as JPlan
from torcheval_tpu_torch.metrics import _bucket as tbucket
from torcheval_tpu_torch.metrics.metric import UpdatePlan as TPlan
from torcheval_tpu_torch.metrics.metric import as_update_plan
from torcheval_tpu_torch.utils.convert import numpy_state_dict

def _modules(path):
    """The JAX and the port module of one functional path (imported by
    name: a package ``__init__`` may shadow a module with a function)."""
    return (importlib.import_module(f"torcheval_tpu.metrics.{path}"),
            importlib.import_module(f"torcheval_tpu_torch.metrics.{path}"))


jacc, tacc = _modules("functional.classification.accuracy")
jbin, tbin = _modules("functional.classification.binned_precision_recall_curve")
jcm, tcm = _modules("functional.classification.confusion_matrix")
jf1, tf1 = _modules("functional.classification.f1_score")
jprec, tprec = _modules("functional.classification.precision")
jrec, trec = _modules("functional.classification.recall")
jmse, tmse = _modules("functional.regression.mean_squared_error")
jr2, tr2 = _modules("functional.regression.r2_score")
jppl, tppl = _modules("functional.text.perplexity")
jwc, twc = _modules("ranking.weighted_calibration")

CPU = "cpu"
RTOL = 1e-6
C = 5  # classes / labels
B = 16  # the bucket the twin cases pad to


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _assert_same(got, want, exact):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if exact:
        np.testing.assert_array_equal(got.astype(np.float64), want.astype(np.float64))
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


# ------------------------------------------------------------ bucket sizes


@pytest.mark.parametrize("min_bucket", [1, 8, 32])
def test_bucket_length_and_bound_match_jax(min_bucket):
    for n in list(range(0, 70)) + [1000, 1023, 1024, 1025, 65_536, 89_137_319]:
        assert tbucket.bucket_length(n, min_bucket) == jbucket.bucket_length(n, min_bucket)
        assert tbucket.bucket_bound(n, min_bucket) == jbucket.bucket_bound(n, min_bucket)
    assert tbucket.MIN_BUCKET == jbucket.MIN_BUCKET == 8
    assert tbucket.bucket_bound(1024) == 8


# --------------------------------------------------------- the plan rewrite


def _kernel(*args):
    return None


def _masked(*args):
    return None


@pytest.mark.parametrize(
    "shapes,axes",
    [
        (((13, 5), (13,)), (("batch",), ("batch",))),
        (((16, 5), (16,)), (("batch",), ("batch",))),  # already a bucket
        (((3,), (3,), (7,)), (("batch",), ("batch",), None)),  # an unlabelled grid
        (((3, 100, 11), (3, 100)), (("batch", "seq"), ("batch", "seq"))),
        (((9,), (9, 20), (20,)), (("b",), ("b", "s"), ("s",))),
        (((33, 4), (33,), ()), (("n",), ("n",), ())),
    ],
)
def test_apply_bucketing_rewrite_matches_jax(shapes, axes):
    rng = np.random.default_rng(0)
    arrays = [np.asarray(rng.random(s) + 1.0, dtype=np.float32) for s in shapes]
    tplan = TPlan(_kernel, ("s",), tuple(torch.from_numpy(a) for a in arrays),
                  (3,), masked_kernel=_masked, batch_axes=axes)
    jplan = JPlan(_kernel, ("s",), tuple(arrays), (3,), masked_kernel=_masked, batch_axes=axes)
    with tconfig.shape_bucketing(), jconfig.shape_bucketing():
        trew = tbucket.apply_bucketing(tplan)
        jrew = jbucket.apply_bucketing(jplan)
    assert trew.kernel is _masked and jrew.kernel is _masked
    assert trew.masked_kernel is None and trew.batch_axes == () == jrew.batch_axes
    assert trew.config == jrew.config
    assert len(trew.dynamic) == len(jrew.dynamic) == len(arrays) + 1
    for p, j in zip(trew.dynamic, jrew.dynamic):
        t = tbucket.materialize(p)
        assert tuple(t.shape) == tuple(np.shape(j))
        np.testing.assert_array_equal(_np(t), np.asarray(j))  # zero padding
    assert tbucket.materialize(trew.dynamic[-1]).dtype == torch.int32
    assert isinstance(trew.dynamic[-1], tbucket.ValidSizes)
    # every labelled argument is a placeholder, padded or not
    for arg, labels in zip(trew.dynamic, axes):
        assert isinstance(arg, tbucket.Padded) == bool(labels)


def test_apply_bucketing_rejects_mismatched_labels_like_jax():
    a, b = np.zeros((5, 2), np.float32), np.zeros((6,), np.float32)
    axes = (("batch",), ("batch",))
    with tconfig.shape_bucketing(), jconfig.shape_bucketing():
        with pytest.raises(ValueError) as terr:
            tbucket.apply_bucketing(TPlan(_kernel, (), (torch.from_numpy(a), torch.from_numpy(b)),
                                          masked_kernel=_masked, batch_axes=axes))
        with pytest.raises(ValueError) as jerr:
            jbucket.apply_bucketing(JPlan(_kernel, (), (a, b), masked_kernel=_masked,
                                          batch_axes=axes))
    assert str(terr.value) == str(jerr.value)


def test_apply_bucketing_is_a_no_op_when_off_or_undeclared():
    x = torch.zeros(5)
    plan = TPlan(_kernel, (), (x,), masked_kernel=_masked, batch_axes=(("batch",),))
    assert tbucket.apply_bucketing(plan) is plan  # knob off by default
    with tconfig.shape_bucketing():
        bare = TPlan(_kernel, (), (x,))
        assert tbucket.apply_bucketing(bare) is bare
        legacy = as_update_plan((_kernel, (), (x,)), None)
        assert tbucket.apply_bucketing(legacy) is legacy


def test_pad_cache_pads_each_shared_tensor_once_and_pins_it():
    x, y = torch.arange(10.0), torch.arange(10)
    cache = {}
    axes = (("batch",), ("batch",))
    with tconfig.shape_bucketing():
        a = tbucket.apply_bucketing(TPlan(_kernel, (), (x, y), masked_kernel=_masked,
                                          batch_axes=axes), cache)
        b = tbucket.apply_bucketing(TPlan(_kernel, (), (x, y), masked_kernel=_masked,
                                          batch_axes=axes), cache)
    assert a.dynamic[0] is b.dynamic[0] and a.dynamic[1] is b.dynamic[1]
    assert a.dynamic[2] is b.dynamic[2]  # one valid vector for equal extents
    assert any(entry[0] is x for entry in cache.values() if isinstance(entry, tuple))
    assert tuple(a.dynamic[0].shape) == (16,)


# --------------------------------------------------------- the masked twins


def _pad_rows(a, n):
    """``a`` with rows ``n:`` zeroed (the pad of an n-row batch)."""
    a = np.array(a, copy=True)
    a[n:] = 0
    return a


def _scores(rng, shape):
    return rng.random(shape).astype(np.float32)


def _labels(rng, shape, hi):
    return rng.integers(0, hi, shape).astype(np.int32)


def _mc(rng, n):
    return [_pad_rows(_scores(rng, (B, C)), n), _pad_rows(_labels(rng, (B,), C), n)]


def _bin(rng, n):
    return [_pad_rows(_scores(rng, (B,)), n), _pad_rows(_labels(rng, (B,), 2), n)]


def _ml(rng, n):
    return [_pad_rows(_scores(rng, (B, C)), n), _pad_rows(_labels(rng, (B, C), 2), n)]


THRESH = np.linspace(0.0, 1.0, 7).astype(np.float32)


def _with_threshold(make):
    return lambda rng, n: make(rng, n) + [THRESH]


def _regression(cols, weighted=False):
    def make(rng, n):
        shape = (B,) if cols is None else (B, cols)
        out = [_pad_rows(_scores(rng, shape), n), _pad_rows(_scores(rng, shape), n)]
        if weighted:
            out.append(_pad_rows(_scores(rng, (B,)) + 0.5, n))
        return out
    return make


def _ppl(rng, sizes):
    b, s = sizes
    x = rng.standard_normal((8, 32, 11)).astype(np.float32)
    t = _labels(rng, (8, 32), 11)
    t[0, 1] = -100
    x[b:], x[:, s:] = 0, 0
    t[b:], t[:, s:] = 0, 0
    return [x, t]


def _wc_rows(scalar_weight):
    def make(rng, n):
        out = [_pad_rows(_scores(rng, (B,)), n), _pad_rows(_labels(rng, (B,), 2).astype(np.float32), n)]
        out.append(np.float32(2.0) if scalar_weight else _pad_rows(_scores(rng, (B,)) + 0.5, n))
        ids = _labels(rng, (B,), 4)  # id 3 is out of range for 3 tasks
        out.append(_pad_rows(ids, n))
        return out
    return make


# (name, jax twin, port twin, input maker, config, exact)
TWINS = [
    ("mc_acc_micro", jacc._multiclass_accuracy_update_masked, tacc._multiclass_accuracy_update_masked,
     _mc, ("micro", None, 1), True),
    ("mc_acc_macro", jacc._multiclass_accuracy_update_masked, tacc._multiclass_accuracy_update_masked,
     _mc, ("macro", C, 1), True),
    ("mc_acc_none_k2", jacc._multiclass_accuracy_update_masked, tacc._multiclass_accuracy_update_masked,
     _mc, (None, C, 2), True),
    ("binary_acc", jacc._binary_accuracy_update_masked, tacc._binary_accuracy_update_masked,
     _bin, (0.5,), True),
    *[(f"multilabel_acc_{c}", jacc._multilabel_accuracy_update_masked,
       tacc._multilabel_accuracy_update_masked, _ml, (0.5, c), True)
      for c in ("exact_match", "hamming", "overlap", "contain", "belong")],
    *[(f"topk_acc_{c}", jacc._topk_multilabel_accuracy_update_masked,
       tacc._topk_multilabel_accuracy_update_masked, _ml, (c, 2), True)
      for c in ("exact_match", "hamming", "overlap")],
    ("precision_macro", jprec._precision_update_masked, tprec._precision_update_masked,
     _mc, (C, "macro"), True),
    ("precision_micro", jprec._precision_update_masked, tprec._precision_update_masked,
     _mc, (C, "micro"), True),
    ("binary_precision", jprec._binary_precision_update_masked,
     tprec._binary_precision_update_masked, _bin, (0.5,), True),
    ("recall_none", jrec._recall_update_masked, trec._recall_update_masked, _mc, (C, None), True),
    ("recall_micro", jrec._recall_update_masked, trec._recall_update_masked, _mc, (C, "micro"), True),
    ("binary_recall", jrec._binary_recall_update_masked, trec._binary_recall_update_masked,
     _bin, (0.5,), True),
    ("f1_macro", jf1._f1_score_update_masked, tf1._f1_score_update_masked, _mc, (C, "macro"), True),
    ("f1_micro", jf1._f1_score_update_masked, tf1._f1_score_update_masked, _mc, (C, "micro"), True),
    ("binary_f1", jf1._binary_f1_score_update_masked, tf1._binary_f1_score_update_masked,
     _bin, (0.5,), True),
    ("confusion_matrix", jcm._confusion_matrix_update_masked, tcm._confusion_matrix_update_masked,
     _mc, (C,), True),
    ("binary_confusion_matrix", jcm._binary_confusion_matrix_update_masked,
     tcm._binary_confusion_matrix_update_masked, _bin, (0.5,), True),
    ("binned_binary", jbin._binary_binned_update_masked_jit, tbin._binary_binned_update_masked_jit,
     _with_threshold(_bin), (), True),
    ("binned_mc_vectorized", jbin._multiclass_binned_update_vectorized_masked,
     tbin._multiclass_binned_update_vectorized_masked, _with_threshold(_mc), (), True),
    ("binned_mc_memory", jbin._multiclass_binned_update_memory_masked,
     tbin._multiclass_binned_update_memory_masked, _with_threshold(_mc), (), True),
    ("binned_ml_vectorized", jbin._multilabel_binned_update_vectorized_masked,
     tbin._multilabel_binned_update_vectorized_masked, _with_threshold(_ml), (), True),
    ("binned_ml_memory", jbin._multilabel_binned_update_memory_masked,
     tbin._multilabel_binned_update_memory_masked, _with_threshold(_ml), (), True),
    ("mse_unweighted", jmse._update_unweighted_masked, tmse._update_unweighted_masked,
     _regression(None), (), False),
    ("mse_unweighted_2d", jmse._update_unweighted_masked, tmse._update_unweighted_masked,
     _regression(3), (), False),
    ("mse_weighted", jmse._update_weighted_masked, tmse._update_weighted_masked,
     _regression(None, weighted=True), (), False),
    ("mse_weighted_2d", jmse._update_weighted_masked, tmse._update_weighted_masked,
     _regression(3, weighted=True), (), False),
    ("r2", jr2._update_masked, tr2._update_masked, _regression(None), (), False),
    ("r2_2d", jr2._update_masked, tr2._update_masked, _regression(3), (), False),
    ("wc_rows", jwc._wc_scatter_rows_masked, twc._wc_scatter_rows_masked,
     _wc_rows(False), (3,), False),
    ("wc_rows_scalar_weight", jwc._wc_scatter_rows_masked, twc._wc_scatter_rows_masked,
     _wc_rows(True), (3,), False),
]


@pytest.mark.parametrize("n", [1, 7, B])
@pytest.mark.parametrize("case", TWINS, ids=[c[0] for c in TWINS])
def test_masked_twin_matches_jax(case, n):
    name, jfn, tfn, make, config, exact = case
    rng = np.random.default_rng(sum(map(ord, name)) + n)
    args = make(rng, n)
    valid = np.array([n], dtype=np.int32)
    want = jfn(*[jnp.asarray(a) for a in args], jnp.asarray(valid), *config)
    got = tfn(*[torch.from_numpy(np.asarray(a)) for a in args], torch.from_numpy(valid), *config)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _assert_same(g, w, exact)


@pytest.mark.parametrize("sizes", [(1, 1), (3, 17), (8, 32)])
@pytest.mark.parametrize("ignore_index", [None, -100])
def test_perplexity_twin_matches_jax_on_two_axes(sizes, ignore_index):
    rng = np.random.default_rng(sizes[0] * 100 + sizes[1])
    x, t = _ppl(rng, sizes)
    valid = np.array(sizes, dtype=np.int32)
    want = jppl._perplexity_update_masked_jit(jnp.asarray(x), jnp.asarray(t), jnp.asarray(valid),
                                              ignore_index)
    got = tppl._perplexity_update_masked_jit(torch.from_numpy(x), torch.from_numpy(t),
                                             torch.from_numpy(valid), ignore_index)
    _assert_same(got[0], want[0], exact=False)
    _assert_same(got[1], want[1], exact=True)
    assert got[1].dtype == torch.int32


def test_multilabel_update_masked_matches_jax():
    rng = np.random.default_rng(5)
    label = _labels(rng, (B, C), 2)
    target = _labels(rng, (B, C), 2)
    valid = (np.arange(B) < 11).astype(np.float32)
    for criteria in ("exact_match", "hamming", "overlap", "contain", "belong"):
        want = jacc._multilabel_update_masked(jnp.asarray(label), jnp.asarray(target),
                                              jnp.asarray(valid), criteria)
        got = tacc._multilabel_update_masked(torch.from_numpy(label), torch.from_numpy(target),
                                             torch.from_numpy(valid), criteria)
        for g, w in zip(got, want):
            _assert_same(g, w, exact=True)


def test_valid_mask_takes_a_tensor_count():
    from torcheval_tpu_torch.metrics.functional.tensor_utils import valid_mask

    count = torch.tensor([3], dtype=torch.int32)
    np.testing.assert_array_equal(_np(valid_mask(6, count[0])), [1, 1, 1, 0, 0, 0])
    np.testing.assert_array_equal(_np(valid_mask(4, 2, dtype=torch.bool)), [True, True, False, False])


# ------------------------------------------------------ bucket-aware classes

RAGGED = [16, 13, 5, 9, 16, 3, 1, 12]


def _mc_batch(rng, n):
    return _scores(rng, (n, C)), _labels(rng, (n,), C)


def _bin_batch(rng, n):
    return _scores(rng, (n,)), _labels(rng, (n,), 2)


def _ml_batch(rng, n):
    return _scores(rng, (n, C)), _labels(rng, (n, C), 2)


def _reg_batch(cols):
    def make(rng, n):
        shape = (n,) if cols is None else (n, cols)
        return _scores(rng, shape), _scores(rng, shape)
    return make


def _reg_weighted(rng, n):
    x, y = _reg_batch(None)(rng, n)
    return x, y, {"sample_weight": _scores(rng, (n,)) + 0.5}


def _ppl_batch(rng, n):
    s = 3 + (n * 7) % 13
    t = _labels(rng, (n, s), 11)
    t[0, 0] = -100
    return rng.standard_normal((n, s, 11)).astype(np.float32), t


def _wc_batch(rng, n):
    return (_scores(rng, (n,)), _labels(rng, (n,), 2).astype(np.float32), _scores(rng, (n,)) + 0.5,
            {"task_ids": _labels(rng, (n,), 4)})


def _wc_scalar_batch(rng, n):
    x, y, _, kw = _wc_batch(rng, n)
    return x, y, 2.0, kw


# (name, constructor kwargs, batch maker, float states compared within RTOL)
CLASSES = [
    ("MulticlassAccuracy", {}, _mc_batch, False),
    ("MulticlassAccuracy", {"average": "macro", "num_classes": C, "k": 2}, _mc_batch, False),
    ("BinaryAccuracy", {}, _bin_batch, False),
    ("MultilabelAccuracy", {"criteria": "hamming"}, _ml_batch, False),
    ("TopKMultilabelAccuracy", {"criteria": "contain", "k": 2}, _ml_batch, False),
    ("MulticlassPrecision", {"num_classes": C, "average": "macro"}, _mc_batch, False),
    ("BinaryPrecision", {}, _bin_batch, False),
    ("MulticlassRecall", {"num_classes": C, "average": None}, _mc_batch, False),
    ("BinaryRecall", {}, _bin_batch, False),
    ("MulticlassF1Score", {"num_classes": C, "average": "weighted"}, _mc_batch, False),
    ("BinaryF1Score", {}, _bin_batch, False),
    ("MulticlassConfusionMatrix", {"num_classes": C}, _mc_batch, False),
    ("BinaryConfusionMatrix", {}, _bin_batch, False),
    ("BinaryBinnedPrecisionRecallCurve", {"threshold": 7}, _bin_batch, False),
    ("MulticlassBinnedPrecisionRecallCurve", {"num_classes": C, "threshold": 7}, _mc_batch, False),
    ("MulticlassBinnedPrecisionRecallCurve",
     {"num_classes": C, "threshold": 7, "optimization": "memory"}, _mc_batch, False),
    ("MultilabelBinnedPrecisionRecallCurve", {"num_labels": C, "threshold": 7}, _ml_batch, False),
    ("MultilabelBinnedPrecisionRecallCurve",
     {"num_labels": C, "threshold": 7, "optimization": "memory"}, _ml_batch, False),
    ("MeanSquaredError", {}, _reg_batch(None), True),
    ("MeanSquaredError", {"multioutput": "raw_values"}, _reg_batch(3), True),
    ("MeanSquaredError", {}, _reg_weighted, True),
    ("R2Score", {}, _reg_batch(None), True),
    ("R2Score", {"multioutput": "raw_values"}, _reg_batch(3), True),
    ("Perplexity", {"ignore_index": -100}, _ppl_batch, True),
    ("WeightedCalibration", {"num_tasks": 3}, _wc_batch, True),
    ("WeightedCalibration", {"num_tasks": 3}, _wc_scalar_batch, True),
]


def _split(batch):
    kwargs = batch[-1] if isinstance(batch[-1], dict) else {}
    args = batch[:-1] if kwargs else batch
    return args, kwargs


def _stream(metric, maker, seed, convert):
    rng = np.random.default_rng(seed)
    for n in RAGGED:
        args, kwargs = _split(maker(rng, n))
        metric.update(*[convert(a) for a in args], **{k: convert(v) for k, v in kwargs.items()})
    return metric


def _torch_in(a):
    return torch.from_numpy(np.asarray(a)) if isinstance(a, np.ndarray) else a


def _compare_states(got, want, floats):
    assert set(got) == set(want)
    for name in got:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        assert g.dtype == w.dtype, name
        _assert_same(g, w, exact=not (floats and np.issubdtype(g.dtype, np.floating)))


@pytest.mark.parametrize("case", CLASSES, ids=[f"{c[0]}-{i}" for i, c in enumerate(CLASSES)])
def test_bucketed_class_stream_matches_unbucketed_and_jax(case):
    cls, kwargs, maker, floats = case
    plain = _stream(getattr(TM, cls)(device=CPU, **kwargs), maker, 7, _torch_in)
    with tconfig.shape_bucketing():
        bucketed = _stream(getattr(TM, cls)(device=CPU, **kwargs), maker, 7, _torch_in)
    with jconfig.shape_bucketing():
        theirs = _stream(getattr(JM, cls)(**kwargs), maker, 7, lambda a: a)
    _compare_states(numpy_state_dict(bucketed), numpy_state_dict(plain), floats)
    jstates = {k: np.asarray(v) for k, v in theirs.state_dict().items()}
    _compare_states(numpy_state_dict(bucketed), jstates, floats)


def test_bucketed_plan_declares_the_jax_axes():
    """Each class's plan names the same masked kernel and ragged axes as
    the JAX class's plan."""
    rng = np.random.default_rng(1)
    for cls, kwargs, maker, _ in CLASSES:
        args, kw = _split(maker(rng, 6))
        tplan = getattr(TM, cls)(device=CPU, **kwargs)._update_plan(
            *[_torch_in(a) for a in args], **{k: _torch_in(v) for k, v in kw.items()})
        jplan = getattr(JM, cls)(**kwargs)._update_plan(*args, **kw)
        assert tplan.batch_axes == jplan.batch_axes, cls
        assert tplan.masked_kernel.__name__ == jplan.masked_kernel.__name__, cls


# -------------------------------------------------------------- the knob


def test_shape_bucketing_knob_defaults_off_and_is_independent(monkeypatch):
    assert tconfig.shape_bucketing_enabled() is False
    with tconfig.shape_bucketing():
        assert tconfig.shape_bucketing_enabled() and not jconfig.shape_bucketing_enabled()
    with jconfig.shape_bucketing():
        assert not tconfig.shape_bucketing_enabled()
    tconfig.set_shape_bucketing(True)
    try:
        assert tconfig.shape_bucketing_enabled()
    finally:
        tconfig.set_shape_bucketing(False)
    assert tconfig.shape_bucketing_enabled() is False


def test_env_spellings_match_jax_in_a_fresh_process():
    import os
    import subprocess
    import sys

    code = (
        "import torcheval_tpu_torch.config as t, torcheval_tpu.config as j;"
        "print(t.shape_bucketing_enabled(), j.shape_bucketing_enabled(),"
        " t.update_donation_enabled('cuda:0'), j.update_donation_enabled())"
    )
    env = dict(os.environ, TORCHEVAL_TPU_SHAPE_BUCKETING="Yes",
               TORCHEVAL_TPU_UPDATE_DONATION="off", JAX_PLATFORMS="cpu")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=root, capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.split() == ["True", "True", "False", "False"]
