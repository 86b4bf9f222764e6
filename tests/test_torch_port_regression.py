"""torcheval_tpu_torch's regression metrics -- ``mean_squared_error``,
``r2_score``, ``MeanSquaredError`` and ``R2Score`` -- against the JAX
package on the same numpy inputs: every ``multioutput`` mode and its
errors, weighted and unweighted MSE, adjusted R2, the float32 ``num_obs``
counter past 2^24, and the classes through update, compute,
``merge_state``, a ``state_dict`` cross-load both ways and
``MetricClassTester``.

Tolerances: on integer-valued data every sum is exact and the states and
values are held bitwise; on random float data the states and values are
held within rtol 1e-6 (XLA and torch sum in other orders).
"""

from __future__ import annotations

import doctest
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as JM
import torcheval_tpu.metrics.functional as JF
import torcheval_tpu_torch.metrics as TM
import torcheval_tpu_torch.metrics.functional as TF
from torcheval_tpu_torch.utils import load_numpy_state_dict, numpy_state_dict
from torcheval_tpu_torch.utils.test_utils import MetricClassTester

CPU = "cpu"
RTOL = 1e-6


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _same(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, got.dtype,
                                                                  want.shape, want.dtype)
    assert got.tobytes() == want.tobytes(), (got, want)


def _close(got, want, rtol=RTOL):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, got.dtype,
                                                                  want.shape, want.dtype)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0, equal_nan=True)


def _assert_states(tm, jm, bitwise=True):
    assert set(tm._state_name_to_default) == set(jm._state_name_to_default)
    for name in jm._state_name_to_default:
        (_same if bitwise else _close)(getattr(tm, name), getattr(jm, name))
    for name, kind in jm._state_name_to_merge_kind.items():
        assert tm._state_name_to_merge_kind[name].value == kind.value, name


def _data(seed, shape, exact):
    rng = np.random.default_rng(seed)
    if exact:
        target = rng.integers(-8, 9, shape).astype(np.float32)
        return target + rng.integers(-3, 4, shape).astype(np.float32), target
    target = rng.standard_normal(shape).astype(np.float32)
    return target + 0.3 * rng.standard_normal(shape).astype(np.float32), target


def _weights(seed, n, exact):
    rng = np.random.default_rng(seed + 1)
    return (rng.integers(0, 4, n) if exact else rng.random(n)).astype(np.float32)


SHAPES = [(1,), (7,), (300,), (5, 1), (40, 3), (17, 8)]


# ------------------------------------------------------------ functional MSE


@pytest.mark.parametrize("multioutput", ["uniform_average", "raw_values"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("exact", [True, False], ids=["int", "float"])
def test_mean_squared_error_matches_jax(exact, shape, weighted, multioutput):
    x, y = _data(sum(shape), shape, exact)
    w = _weights(sum(shape), shape[0], exact) if weighted else None
    got = TF.mean_squared_error(torch.from_numpy(x), torch.from_numpy(y),
                                sample_weight=None if w is None else torch.from_numpy(w),
                                multioutput=multioutput)
    want = JF.mean_squared_error(x, y, sample_weight=w, multioutput=multioutput)
    (_same if exact else _close)(got, want)


def test_mean_squared_error_of_empty_input_is_nan_like_jax():
    x = np.zeros(0, np.float32)
    _same(TF.mean_squared_error(x, x, device=CPU), JF.mean_squared_error(x, x))


def test_mean_squared_error_of_negative_weights_keeps_the_sign_like_jax():
    x, y = _data(3, (6,), True)
    w = np.array([-1, -2, 0, -1, -3, -1], dtype=np.float32)
    _same(TF.mean_squared_error(x, y, sample_weight=w, device=CPU),
          JF.mean_squared_error(x, y, sample_weight=w))
    zero = np.zeros(6, np.float32)  # weight sum 0: NaN or +-inf in both
    _same(TF.mean_squared_error(x, y, sample_weight=zero, device=CPU),
          JF.mean_squared_error(x, y, sample_weight=zero))


@pytest.mark.parametrize("kwargs", [
    dict(input=np.ones((2, 2, 2)), target=np.ones((2, 2, 2))),
    dict(input=np.ones(3), target=np.ones(4)),
    dict(input=np.ones(3), target=np.ones(3), sample_weight=np.ones(4)),
    dict(input=np.ones((3, 2)), target=np.ones((3, 2)), sample_weight=np.float32(1.0)),
    dict(input=np.ones(3), target=np.ones(3), multioutput="mean"),
])
def test_mean_squared_error_checks_match_jax(kwargs):
    with pytest.raises(ValueError) as want:
        JF.mean_squared_error(**kwargs)
    with pytest.raises(ValueError) as got:
        TF.mean_squared_error(**kwargs, device=CPU)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------ functional R2


@pytest.mark.parametrize("num_regressors", [0, 1, 3])
@pytest.mark.parametrize("multioutput", ["uniform_average", "raw_values", "variance_weighted"])
@pytest.mark.parametrize("shape", [(7,), (300,), (40, 3), (17, 8)])
@pytest.mark.parametrize("exact", [True, False], ids=["int", "float"])
def test_r2_score_matches_jax(exact, shape, multioutput, num_regressors):
    x, y = _data(sum(shape) + 50, shape, exact)
    got = TF.r2_score(torch.from_numpy(x), torch.from_numpy(y), multioutput=multioutput,
                      num_regressors=num_regressors)
    want = JF.r2_score(x, y, multioutput=multioutput, num_regressors=num_regressors)
    (_same if exact else _close)(got, want)


def test_r2_score_of_a_constant_target_matches_jax():
    # tss = 0: -inf, nan or inf in both packages
    y = np.full((6, 2), 3.0, np.float32)
    x = np.array([[3, 4], [3, 3], [3, 3], [3, 2], [3, 3], [3, 3]], np.float32)
    for multioutput in ("uniform_average", "raw_values", "variance_weighted"):
        _same(TF.r2_score(x, y, multioutput=multioutput, device=CPU),
              JF.r2_score(x, y, multioutput=multioutput))


@pytest.mark.parametrize("kwargs, exc", [
    (dict(input=np.ones(1), target=np.ones(1)), ValueError),
    (dict(input=np.arange(4.0), target=np.arange(4.0), num_regressors=3), ValueError),
    (dict(input=np.ones((2, 2, 2)), target=np.ones((2, 2, 2))), ValueError),
    (dict(input=np.ones(3), target=np.ones(4)), ValueError),
    (dict(input=np.ones(3), target=np.ones(3), multioutput="mean"), ValueError),
    (dict(input=np.ones(3), target=np.ones(3), num_regressors=-1), ValueError),
    (dict(input=np.ones(3), target=np.ones(3), num_regressors=1.0), ValueError),
])
def test_r2_score_checks_match_jax(kwargs, exc):
    with pytest.raises(exc) as want:
        JF.r2_score(**kwargs)
    with pytest.raises(exc) as got:
        TF.r2_score(**kwargs, device=CPU)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------ classes


CLASSES = {
    "mse": (lambda P, **k: P.MeanSquaredError(**k), False, (9,)),
    "mse_weighted": (lambda P, **k: P.MeanSquaredError(**k), True, (9,)),
    "mse_raw_2d": (lambda P, **k: P.MeanSquaredError(multioutput="raw_values", **k), True, (9, 4)),
    "r2": (lambda P, **k: P.R2Score(**k), False, (9,)),
    "r2_raw_2d": (lambda P, **k: P.R2Score(multioutput="raw_values", **k), False, (9, 4)),
    "r2_variance_adjusted": (
        lambda P, **k: P.R2Score(multioutput="variance_weighted", num_regressors=2, **k),
        False, (9, 4)),
}
NAMES = sorted(CLASSES)


def _batches(name, exact, n=8):
    _, weighted, shape = CLASSES[name]
    out = []
    for i in range(n):
        x, y = _data(100 * NAMES.index(name) + i, shape, exact)
        kw = {"input": x, "target": y}
        if weighted:
            kw["sample_weight"] = _weights(i, shape[0], exact)
        out.append(kw)
    return out


def _feed(m, batches):
    for kw in batches:
        kw = dict(kw)
        m.update(kw.pop("input"), kw.pop("target"), **kw)
    return m


@pytest.mark.parametrize("exact", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("name", NAMES)
def test_class_update_compute_reset_matches_jax(name, exact):
    make = CLASSES[name][0]
    tm, jm = make(TM, device=CPU), make(JM)
    for kw in _batches(name, exact):
        _feed(tm, [kw])
        _feed(jm, [kw])
        _assert_states(tm, jm, bitwise=exact)
        (_same if exact else _close)(tm.compute(), jm.compute())
    tm.reset()
    jm.reset()
    _assert_states(tm, jm)


def test_mean_squared_error_class_is_nan_before_an_update_like_jax():
    _same(TM.MeanSquaredError(device=CPU).compute(), JM.MeanSquaredError().compute())


def test_r2_class_raises_before_two_samples_like_jax():
    for P, k in ((TM, {"device": CPU}), (JM, {})):
        m = P.R2Score(**k)
        with pytest.raises(ValueError, match="at least two samples"):
            m.compute()
        m.update(np.ones(1, np.float32), np.ones(1, np.float32))
        with pytest.raises(ValueError, match="at least two samples"):
            m.compute()


@pytest.mark.parametrize("kwargs", [
    dict(multioutput="mean"), dict(num_regressors=-2), dict(num_regressors=0.5),
])
def test_r2_class_parameter_checks_match_jax(kwargs):
    with pytest.raises(ValueError) as want:
        JM.R2Score(**kwargs)
    with pytest.raises(ValueError) as got:
        TM.R2Score(**kwargs, device=CPU)
    assert str(got.value) == str(want.value)


def test_mse_class_parameter_check_matches_jax():
    with pytest.raises(ValueError) as want:
        JM.MeanSquaredError(multioutput="variance_weighted")
    with pytest.raises(ValueError) as got:
        TM.MeanSquaredError(multioutput="variance_weighted", device=CPU)
    assert str(got.value) == str(want.value)


def test_r2_num_obs_is_a_float32_counter_past_2_24_like_jax():
    """``num_obs`` rounds like the JAX package's float32 counter: 2^24 + 3
    samples read as 2^24 + 4 in both."""
    tm, jm = TM.R2Score(device=CPU), JM.R2Score()
    x, y = _data(9, (3,), True)
    sd = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    sd["num_obs"] = np.float32(2 ** 24)
    load_numpy_state_dict(tm, sd)
    jm.load_state_dict({k: jnp.asarray(v) for k, v in sd.items()})
    tm.update(x, y)
    jm.update(x, y)
    _assert_states(tm, jm)
    assert float(tm.num_obs) == 2 ** 24 + 4 and tm.num_obs.dtype == torch.float32


@pytest.mark.parametrize("exact", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("name", NAMES)
def test_class_merge_then_compute_matches_jax(name, exact):
    make = CLASSES[name][0]
    batches = _batches(name, exact, 6)
    tms, jms = [make(TM, device=CPU) for _ in range(3)], [make(JM) for _ in range(3)]
    for i, kw in enumerate(batches):
        _feed(tms[i % 3], [kw])
        _feed(jms[i % 3], [kw])
    tms[0].merge_state(tms[1:])
    jms[0].merge_state(jms[1:])
    _assert_states(tms[0], jms[0], bitwise=exact)
    (_same if exact else _close)(tms[0].compute(), jms[0].compute())


def test_a_scalar_state_merges_with_a_per_output_one_like_jax():
    """A fresh replica's scalar sums broadcast against a 2-D replica's
    per-output sums under the SUM merge, as in the JAX package."""
    x, y = _data(4, (6, 3), True)
    tm = TM.MeanSquaredError(multioutput="raw_values", device=CPU).update(x, y)
    jm = JM.MeanSquaredError(multioutput="raw_values").update(x, y)
    tm.merge_state([TM.MeanSquaredError(multioutput="raw_values", device=CPU)])
    jm.merge_state([JM.MeanSquaredError(multioutput="raw_values")])
    _assert_states(tm, jm)
    _same(tm.compute(), jm.compute())


@pytest.mark.parametrize("updated", [False, True], ids=["fresh", "updated"])
@pytest.mark.parametrize("name", NAMES)
def test_state_dict_cross_loads_both_ways(name, updated):
    make = CLASSES[name][0]
    batches = _batches(name, True, 4)
    jm = _feed(make(JM), batches[:2] if updated else [])
    tm = make(TM, device=CPU)
    load_numpy_state_dict(tm, {k: np.asarray(v) for k, v in jm.state_dict().items()})
    _assert_states(tm, jm)
    back = make(JM)
    back.load_state_dict({k: jnp.asarray(v) for k, v in numpy_state_dict(tm).items()})
    _assert_states(tm, back)
    _feed(tm, batches[2:])
    _feed(back, batches[2:])
    _assert_states(tm, back)
    _same(tm.compute(), back.compute())


class TestRegressionClasses(MetricClassTester):
    @pytest.mark.parametrize("name", NAMES)
    def test_class_contract(self, name):
        make = CLASSES[name][0]
        batches = _batches(name, False)
        kwargs = {k: [b[k] for b in batches] for k in batches[0]}
        whole = _feed(make(JM), batches)
        ranks = [_feed(make(JM), batches[2 * r:2 * r + 2]) for r in range(4)]
        ranks[0].merge_state(ranks[1:])
        self.run_class_implementation_tests(
            metric=make(TM, device=CPU),
            state_names=set(make(JM)._state_name_to_default),
            update_kwargs=kwargs,
            compute_result=np.asarray(whole.compute()),
            merge_and_compute_result=np.asarray(ranks[0].compute()),
            num_total_updates=8,
            num_processes=4,
            atol=1e-6,
            rtol=1e-5,
        )


# ------------------------------------------------------------ surface


_DOC_MODULES = [
    *[f"torcheval_tpu_torch.metrics.functional.regression.{m}"
      for m in ("mean_squared_error", "r2_score")],
    *[f"torcheval_tpu_torch.metrics.regression.{m}" for m in ("mean_squared_error", "r2_score")],
]


@pytest.mark.parametrize("module", _DOC_MODULES,
                         ids=lambda m: m.rsplit(".", 2)[-2] + "." + m.rsplit(".", 1)[-1])
def test_docstring_examples_run(module):
    result = doctest.testmod(importlib.import_module(module),
                             optionflags=doctest.NORMALIZE_WHITESPACE)
    assert result.attempted > 0 and result.failed == 0


@pytest.mark.parametrize("name", ["MeanSquaredError", "R2Score"])
def test_classes_default_to_cuda(name):
    if torch.cuda.is_available():
        assert getattr(TM, name)().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            getattr(TM, name)()


def test_the_port_exports_the_regression_family():
    for name in ("MeanSquaredError", "R2Score"):
        assert name in TM.__all__ and name in JM.__all__
    for name in ("mean_squared_error", "r2_score"):
        assert name in TF.__all__ and name in JF.__all__
