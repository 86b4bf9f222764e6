"""torcheval_tpu_torch's ``config`` knobs against the JAX package's: the
debug tier's value checks (accuracy, normalized entropy, confusion matrix,
precision, recall, F1, hit rate, reciprocal rank, perplexity and FID)
raise the same exception with the same message, or log the same warning,
on the same planted inputs under each package's own
``debug_validation()``, and with the knob off give the JAX package's
result; the ``validate_inputs`` NaN/Inf guard under ``off``, ``warn`` and
``raise``; the environment spellings; and the independence of the two
packages' knobs.

Tolerances: the values compared with the knob off are the JAX package's
within rtol 1e-6 (float sums in another order); messages, exception types
and warnings are compared exactly.
"""

from __future__ import annotations

import logging
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torcheval_tpu.config as jconfig
import torcheval_tpu.metrics as JM
import torcheval_tpu.metrics.functional as JF
from torcheval_tpu.metrics.image import fid as jfid
import torcheval_tpu_torch.config as tconfig
import torcheval_tpu_torch.metrics as TM
import torcheval_tpu_torch.metrics.functional as TF
from torcheval_tpu_torch.metrics.image import fid as tfid

CPU = "cpu"


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _class_scores(n=16, c=5, seed=0):
    return _rng(seed).random((n, c)).astype(np.float32)


def _bad_targets(n=16, c=5, planted=7):
    t = (np.arange(n) % c).astype(np.int64)
    t[3] = planted
    return t


class _TinyJaxInception(jfid.FIDInceptionV3):
    """An ``FIDInceptionV3`` without the pretrained weights: the channel
    means as 3 features, so the default-model checks apply."""

    def __init__(self):
        pass

    def __call__(self, images):
        return jnp.mean(images, axis=(2, 3))

    def to(self, device):
        return self


class _TinyTorchInception(tfid.FIDInceptionV3):
    def __init__(self):
        torch.nn.Module.__init__(self)

    def forward(self, images):
        return images.mean(dim=(2, 3))


def _images(lo=0.0, hi=1.0, seed=0):
    return _rng(seed).uniform(lo, hi, (4, 3, 5, 5)).astype(np.float32)


# name -> (call on the port, call on the JAX package); each raises under
# debug_validation on its planted input
RAISING = {
    "multiclass_accuracy": (
        lambda: TF.multiclass_accuracy(_class_scores(), _bad_targets(), num_classes=5,
                                       average="macro", device=CPU),
        lambda: JF.multiclass_accuracy(_class_scores(), _bad_targets(), num_classes=5,
                                       average="macro")),
    "MulticlassAccuracy": (
        lambda: TM.MulticlassAccuracy(num_classes=5, average="macro", device=CPU).update(
            _class_scores(), _bad_targets(planted=-2)).compute(),
        lambda: JM.MulticlassAccuracy(num_classes=5, average="macro").update(
            _class_scores(), _bad_targets(planted=-2)).compute()),
    "binary_normalized_entropy": (
        lambda: TF.binary_normalized_entropy(np.array([0.2, 1.5, 0.4], np.float32),
                                             np.array([1.0, 0.0, 1.0], np.float32), device=CPU),
        lambda: JF.binary_normalized_entropy(np.array([0.2, 1.5, 0.4], np.float32),
                                             np.array([1.0, 0.0, 1.0], np.float32))),
    "BinaryNormalizedEntropy": (
        lambda: TM.BinaryNormalizedEntropy(num_tasks=2, device=CPU).update(
            np.array([[0.2, 0.4], [-0.1, 0.5]], np.float32),
            np.array([[1.0, 0.0], [0.0, 1.0]], np.float32)).compute(),
        lambda: JM.BinaryNormalizedEntropy(num_tasks=2).update(
            np.array([[0.2, 0.4], [-0.1, 0.5]], np.float32),
            np.array([[1.0, 0.0], [0.0, 1.0]], np.float32)).compute()),
    "WindowedBinaryNormalizedEntropy": (
        lambda: TM.WindowedBinaryNormalizedEntropy(device=CPU).update(
            np.array([0.2, 1.01], np.float32), np.array([1.0, 0.0], np.float32)).compute(),
        lambda: JM.WindowedBinaryNormalizedEntropy().update(
            np.array([0.2, 1.01], np.float32), np.array([1.0, 0.0], np.float32)).compute()),
    "multiclass_confusion_matrix": (
        lambda: TF.multiclass_confusion_matrix(_class_scores(), _bad_targets(), num_classes=5,
                                               device=CPU),
        lambda: JF.multiclass_confusion_matrix(_class_scores(), _bad_targets(), num_classes=5)),
    "MulticlassConfusionMatrix": (
        lambda: TM.MulticlassConfusionMatrix(5, device=CPU).update(
            _class_scores(), _bad_targets(planted=5)).compute(),
        lambda: JM.MulticlassConfusionMatrix(5).update(
            _class_scores(), _bad_targets(planted=5)).compute()),
    "hit_rate": (
        lambda: TF.hit_rate(_class_scores(), _bad_targets(), k=2, device=CPU),
        lambda: JF.hit_rate(_class_scores(), _bad_targets(), k=2)),
    "HitRate": (
        lambda: TM.HitRate(k=2, device=CPU).update(_class_scores(),
                                                  _bad_targets(planted=-1)).compute(),
        lambda: JM.HitRate(k=2).update(_class_scores(), _bad_targets(planted=-1)).compute()),
    "reciprocal_rank": (
        lambda: TF.reciprocal_rank(_class_scores(), _bad_targets(planted=5), k=3, device=CPU),
        lambda: JF.reciprocal_rank(_class_scores(), _bad_targets(planted=5), k=3)),
    "perplexity": (
        lambda: TF.perplexity(_rng(1).random((2, 4, 6)).astype(np.float32),
                              np.array([[0, 1, -100, 6], [2, 3, 4, 5]]), ignore_index=-100,
                              device=CPU),
        lambda: JF.perplexity(_rng(1).random((2, 4, 6)).astype(np.float32),
                              np.array([[0, 1, -100, 6], [2, 3, 4, 5]]), ignore_index=-100)),
    "Perplexity": (
        lambda: TM.Perplexity(device=CPU).update(_rng(1).random((2, 4, 6)).astype(np.float32),
                                                 np.array([[0, 1, 9, 2], [2, 3, 4, 5]])).compute(),
        lambda: JM.Perplexity().update(_rng(1).random((2, 4, 6)).astype(np.float32),
                                       np.array([[0, 1, 9, 2], [2, 3, 4, 5]])).compute()),
    "FrechetInceptionDistance": (
        lambda: TM.FrechetInceptionDistance(model=_TinyTorchInception(), feature_dim=3,
                                            device=CPU).update(_images(hi=1.2), True),
        lambda: JM.FrechetInceptionDistance(model=_TinyJaxInception(), feature_dim=3).update(
            _images(hi=1.2), True)),
}


@pytest.mark.parametrize("name", sorted(RAISING))
def test_debug_tier_raises_like_jax(name):
    ours, theirs = RAISING[name]
    with jconfig.debug_validation(), pytest.raises(Exception) as jerr:
        theirs()
    with tconfig.debug_validation(), pytest.raises(Exception) as terr:
        ours()
    assert type(terr.value) is type(jerr.value) is ValueError
    assert str(terr.value) == str(jerr.value)


def _value(x):
    if isinstance(x, (JM.Metric, TM.Metric)):
        return None  # an update returns the metric
    return _np(x)


@pytest.mark.parametrize("name", sorted(RAISING))
def test_debug_tier_off_gives_the_jax_result(name):
    ours, theirs = RAISING[name]
    assert not tconfig.debug_validation_enabled() and not jconfig.debug_validation_enabled()
    got, want = _value(ours()), _value(theirs())
    if want is None:
        assert got is None
    else:
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=1e-6, equal_nan=True)


def test_debug_tier_passes_clean_inputs():
    x, t = _class_scores(), np.arange(16) % 5
    with tconfig.debug_validation():
        TM.MulticlassAccuracy(num_classes=5, device=CPU).update(x, t)
        TF.multiclass_confusion_matrix(x, t, num_classes=5, device=CPU)
        TF.hit_rate(x, t, k=2, device=CPU)
        TF.binary_normalized_entropy(np.array([0.0, 1.0], np.float32),
                                     np.array([0.0, 1.0], np.float32), device=CPU)
        TF.perplexity(_rng().random((1, 2, 4)).astype(np.float32), np.array([[3, -100]]),
                      ignore_index=-100, device=CPU)
        TM.FrechetInceptionDistance(model=_TinyTorchInception(), feature_dim=3,
                                    device=CPU).update(_images(), False)


# name -> (port call, JAX call); each logs one warning under debug_validation
WARNING = {
    "precision": (
        lambda: TF.multiclass_precision(np.array([0, 1, 1]), np.array([0, 1, 0]), num_classes=4,
                                        average=None, device=CPU),
        lambda: JF.multiclass_precision(np.array([0, 1, 1]), np.array([0, 1, 0]), num_classes=4,
                                        average=None)),
    "MulticlassRecall": (
        lambda: TM.MulticlassRecall(num_classes=4, average=None, device=CPU).update(
            np.array([0, 3, 1]), np.array([0, 1, 0])).compute(),
        lambda: JM.MulticlassRecall(num_classes=4, average=None).update(
            np.array([0, 3, 1]), np.array([0, 1, 0])).compute()),
    "f1_score": (
        lambda: TF.multiclass_f1_score(np.array([0, 2, 1]), np.array([0, 1, 0]), num_classes=3,
                                       average="macro", device=CPU),
        lambda: JF.multiclass_f1_score(np.array([0, 2, 1]), np.array([0, 1, 0]), num_classes=3,
                                       average="macro")),
    "MulticlassF1Score": (
        lambda: TM.MulticlassF1Score(num_classes=3, average=None, device=CPU).update(
            np.array([0, 2, 1]), np.array([0, 1, 0])).compute(),
        lambda: JM.MulticlassF1Score(num_classes=3, average=None).update(
            np.array([0, 2, 1]), np.array([0, 1, 0])).compute()),
}


def _warnings(caplog, call, knob):
    caplog.clear()
    with caplog.at_level(logging.WARNING), knob():
        value = call()
    return value, [r.getMessage() for r in caplog.records]


@pytest.mark.parametrize("name", sorted(WARNING))
def test_debug_tier_warnings_match_jax(name, caplog):
    ours, theirs = WARNING[name]
    want, jlog = _warnings(caplog, theirs, jconfig.debug_validation)
    got, tlog = _warnings(caplog, ours, tconfig.debug_validation)
    assert len(jlog) == 1 and tlog == jlog
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6)
    # the knob off: no warning, the same value
    _, quiet = _warnings(caplog, ours, lambda: tconfig.debug_validation(False))
    assert quiet == []


# ------------------------------------------------------------ input guard


def _guard_cases():
    nan = np.array([0.2, np.nan, 0.4], np.float32)
    inf = np.array([0.2, 0.1, -np.inf], np.float32)
    return {"nan": nan, "inf": inf}


@pytest.mark.parametrize("bad", ["nan", "inf"])
@pytest.mark.parametrize("policy", ["off", "warn", "raise"])
def test_validate_inputs_matches_jax(policy, bad):
    x = _guard_cases()[bad]
    y = np.array([1.0, 0.0, 1.0], np.float32)

    def run(P, knob, **kw):
        with knob(policy), warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                value = P.BinaryNormalizedEntropy(**kw).update(x, y).compute()
            except ValueError as e:
                return "raised", str(e), []
        return _np(value), None, [(w.category, str(w.message)) for w in caught
                                  if "validate_inputs" in str(w.message)]

    got = run(TM, tconfig.validate_inputs, device=CPU)
    want = run(JM, jconfig.validate_inputs)
    if policy == "raise":
        assert got[0] == want[0] == "raised" and got[1] == want[1]
        assert "non-finite" in got[1]
        return
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, equal_nan=True)
    assert got[2] == want[2] and len(got[2]) == (policy == "warn")


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.bool_])
def test_validate_inputs_passes_integer_inputs(dtype):
    clicks = np.array([1, 0, 1, 1], dtype)
    with tconfig.validate_inputs("raise"):
        got = TM.ClickThroughRate(device=CPU).update(clicks).compute()
        TM.MulticlassAccuracy(device=CPU).update(np.array([0, 1, 1, 0], dtype),
                                                 np.array([0, 1, 0, 0], dtype))
    want = JM.ClickThroughRate().update(clicks).compute()
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6)


def test_validate_inputs_off_reads_nothing_back(monkeypatch):
    """Under "off" the guard never looks at the values."""
    calls = []
    real = torch.isfinite
    monkeypatch.setattr(torch, "isfinite", lambda x: calls.append(1) or real(x))
    TM.Sum(device=CPU).update(np.array([np.nan], np.float32))
    assert calls == []
    with tconfig.validate_inputs("warn"), pytest.warns(RuntimeWarning, match="non-finite"):
        TM.Sum(device=CPU).update(np.array([np.nan], np.float32))
    assert calls == [1]


def test_set_validate_inputs_rejects_unknown_policies_like_jax():
    with pytest.raises(ValueError) as jerr:
        jconfig.set_validate_inputs("loud")
    with pytest.raises(ValueError) as terr:
        tconfig.set_validate_inputs("loud")
    assert str(terr.value) == str(jerr.value)
    assert tconfig.validate_inputs_policy() == "off"


# --------------------------------------------------- environment and state


@pytest.mark.parametrize("raw,want", [("1", True), ("TRUE", True), ("on", True), ("yes", True),
                                      ("0", False), ("off", False), ("", False), ("maybe", False)])
def test_env_truthy_spellings_match_jax(monkeypatch, raw, want):
    monkeypatch.setenv("TORCHEVAL_TPU_TEST_KNOB", raw)
    assert tconfig.env_truthy("TORCHEVAL_TPU_TEST_KNOB") is want
    assert jconfig.env_truthy("TORCHEVAL_TPU_TEST_KNOB") is want
    assert tconfig._TRUTHY == jconfig._TRUTHY and tconfig._FALSY == jconfig._FALSY


@pytest.mark.parametrize("raw,want", [("", "off"), ("WARN", "warn"), (" raise ", "raise"),
                                      ("loud", "off")])
def test_env_choice_matches_jax(monkeypatch, raw, want):
    monkeypatch.setenv("TORCHEVAL_TPU_TEST_POLICY", raw)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = tconfig._env_choice("TORCHEVAL_TPU_TEST_POLICY", "off", tconfig._VALIDATE_POLICIES)
        theirs = jconfig._env_choice("TORCHEVAL_TPU_TEST_POLICY", "off", jconfig._VALIDATE_POLICIES)
    assert got == theirs == want
    assert len(caught) == 2 * (raw == "loud")
    if caught:
        assert str(caught[0].message) == str(caught[1].message)


def test_defaults_are_off_like_jax():
    assert tconfig.debug_validation_enabled() is False
    assert tconfig.validate_inputs_policy() == "off"
    assert tconfig._VALIDATE_POLICIES == jconfig._VALIDATE_POLICIES


def test_the_two_packages_knobs_are_independent():
    with tconfig.debug_validation():
        assert tconfig.debug_validation_enabled() and not jconfig.debug_validation_enabled()
    with jconfig.debug_validation():
        assert jconfig.debug_validation_enabled() and not tconfig.debug_validation_enabled()
    with tconfig.validate_inputs("warn"):
        assert jconfig.validate_inputs_policy() == "off"
        with jconfig.validate_inputs("raise"):
            assert tconfig.validate_inputs_policy() == "warn"
    tconfig.set_debug_validation(True)
    try:
        assert not jconfig.debug_validation_enabled()
    finally:
        tconfig.set_debug_validation(False)
    assert not tconfig.debug_validation_enabled()
    assert tconfig.validate_inputs_policy() == jconfig.validate_inputs_policy() == "off"
