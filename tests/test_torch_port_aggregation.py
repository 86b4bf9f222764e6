"""torcheval_tpu_torch's aggregation leftovers -- ``Max``, ``Min``, ``Cat``,
``AUC``, ``auc`` and ``throughput`` -- and ``utils.random_data``, against
the JAX package on the same numpy inputs: functional forms over their edge
cases, the classes through update, compute, ``merge_state``, a
``state_dict`` cross-load both ways and ``MetricClassTester``.

Tolerances: ``Max``, ``Min`` and ``Cat`` move values without arithmetic
and are held bitwise. ``auc`` is bitwise on integer-valued and dyadic
points (every product and sum exact); on random float points it is held
within rtol 1e-6 (XLA and torch sum the trapezoids in other orders). The
random generators draw from different RNGs, so only shapes, dtypes,
ranges and determinism under one seed are compared.
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
import torcheval_tpu.utils as JU
import torcheval_tpu_torch.metrics as TM
import torcheval_tpu_torch.metrics.functional as TF
import torcheval_tpu_torch.utils as TU
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
        mine, theirs = getattr(tm, name), getattr(jm, name)
        if isinstance(theirs, (int, float)):
            assert mine == theirs and type(mine) is type(theirs), name
        elif bitwise:
            _same(mine, theirs)
        else:
            _close(mine, theirs)
    for name, kind in jm._state_name_to_merge_kind.items():
        assert tm._state_name_to_merge_kind[name].value == kind.value, name


def _to_jax(sd):
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in sd.items()}


def _numpy_sd(jm):
    return {k: v if isinstance(v, (int, float)) else np.asarray(v)
            for k, v in jm.state_dict().items()}


# ------------------------------------------------------------ throughput


@pytest.mark.parametrize("args", [(64, 2.0), (0, 0.5), (7, 3), (10**9, 1e-3)])
def test_throughput_matches_jax(args):
    got = TF.throughput(*args)
    assert got == JF.throughput(*args) and type(got) is float


@pytest.mark.parametrize("args", [(-1, 1.0), (5, 0.0), (5, -2.0), ()])
def test_throughput_bad_arguments_raise_like_jax(args):
    with pytest.raises(ValueError) as want:
        JF.throughput(*args)
    with pytest.raises(ValueError) as got:
        TF.throughput(*args)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------ functional auc


def _auc_points(seed, shape, kind):
    rng = np.random.default_rng(seed)
    if kind == "int":
        return rng.integers(-5, 6, shape).astype(np.float32), rng.integers(0, 9, shape).astype(
            np.float32)
    if kind == "dyadic":  # quarters: every trapezoid term is exact
        return (rng.integers(0, 8, shape) / 4).astype(np.float32), (
            rng.integers(0, 8, shape) / 4).astype(np.float32)
    return rng.random(shape).astype(np.float32), rng.random(shape).astype(np.float32)


@pytest.mark.parametrize("reorder", [False, True])
@pytest.mark.parametrize("shape", [(1,), (2,), (50,), (1, 9), (3, 40)])
@pytest.mark.parametrize("kind", ["int", "dyadic", "float"])
def test_auc_matches_jax(kind, shape, reorder):
    x, y = _auc_points(len(shape) * 100 + shape[-1], shape, kind)
    got = TF.auc(torch.from_numpy(x), torch.from_numpy(y), reorder=reorder)
    want = JF.auc(x, y, reorder=reorder)
    (_close if kind == "float" else _same)(got, want)


def test_auc_reorder_keeps_tie_order_like_jax():
    # ties in x with different y: the stable order decides the area
    x = np.array([[2, 1, 2, 1, 0, 2, 0], [0, 0, 1, 1, 1, 3, 3]], dtype=np.float32)
    y = np.array([[5, 1, 3, 4, 2, 0, 7], [1, 2, 3, 4, 5, 6, 7]], dtype=np.float32)
    _same(TF.auc(torch.from_numpy(x), torch.from_numpy(y), reorder=True),
          JF.auc(x, y, reorder=True))
    _same(TF.auc(torch.from_numpy(x), torch.from_numpy(y)), JF.auc(x, y))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_auc_of_integer_x_matches_jax(dtype):
    rng = np.random.default_rng(4)
    x = rng.integers(-4, 5, 12).astype(dtype)
    y = rng.random(12).astype(np.float32)
    for reorder in (False, True):
        _close(TF.auc(x, y, reorder=reorder, device=CPU), JF.auc(x, y, reorder=reorder))


@pytest.mark.parametrize("reorder", [False, True])
def test_auc_of_bool_x_raises_like_jax(reorder):
    # the trapezoid cannot subtract bools: both packages raise TypeError
    x, y = np.array([True, False, True]), np.ones(3, np.float32)
    with pytest.raises(TypeError):
        JF.auc(x, y, reorder=reorder)
    with pytest.raises(TypeError, match="bool"):
        TF.auc(x, y, reorder=reorder, device=CPU)


def test_auc_minus_zero_ties_plus_zero_like_jax():
    x = np.array([0.0, -0.0, 0.0, 1.0, -0.0], dtype=np.float32)
    y = np.array([1.0, 2.0, 3.0, 4.0, 5.0], dtype=np.float32)
    _same(TF.auc(x, y, reorder=True, device=CPU), JF.auc(x, y, reorder=True))


@pytest.mark.parametrize("x, y", [
    (np.zeros(0, np.float32), np.zeros(0, np.float32)),
    (np.ones(3, np.float32), np.ones(4, np.float32)),
    (np.ones((2, 3), np.float32), np.ones((3, 2), np.float32)),
])
def test_auc_bad_inputs_raise_like_jax(x, y):
    with pytest.raises(ValueError) as want:
        JF.auc(x, y)
    with pytest.raises(ValueError) as got:
        TF.auc(x, y, device=CPU)
    assert str(got.value) == str(want.value)


def test_auc_runs_where_its_input_lies():
    x = torch.tensor([0.0, 1.0])
    assert TF.auc(x, x).device == x.device
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TF.auc(np.zeros(2), np.zeros(2))


# ------------------------------------------------------------ Max / Min


def _stream(seed, n=6, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(rng.integers(1, 40)) * 10).astype(dtype) for _ in range(n)]


@pytest.mark.parametrize("name", ["Max", "Min"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.int64, np.float16])
def test_max_min_match_jax_bitwise(name, dtype):
    tm, jm = getattr(TM, name)(device=CPU), getattr(JM, name)()
    for x in _stream(7, dtype=dtype):
        tm.update(torch.from_numpy(x))
        jm.update(x)
        _assert_states(tm, jm)
    _same(tm.compute(), jm.compute())


_EMPTY = np.zeros((0,), np.float32)
_EMPTY_CALLS = {
    "Max": (lambda: TM.Max(device=CPU).update(_EMPTY), lambda: JM.Max().update(_EMPTY)),
    "Min": (lambda: TM.Min(device=CPU).update(_EMPTY), lambda: JM.Min().update(_EMPTY)),
    "PeakSignalNoiseRatio": (
        lambda: TM.PeakSignalNoiseRatio(device=CPU).update(_EMPTY, _EMPTY),
        lambda: JM.PeakSignalNoiseRatio().update(_EMPTY, _EMPTY)),
    "peak_signal_noise_ratio": (
        lambda: TF.peak_signal_noise_ratio(_EMPTY, _EMPTY, device=CPU),
        lambda: JF.peak_signal_noise_ratio(_EMPTY, _EMPTY)),
}


@pytest.mark.parametrize("name", sorted(_EMPTY_CALLS))
def test_empty_input_raises_like_jax(name):
    """An empty input has no max or min: ValueError, with numpy's message,
    in both packages (torch's own reductions raise RuntimeError)."""
    ours, theirs = _EMPTY_CALLS[name]
    with pytest.raises(ValueError) as jerr:
        theirs()
    with pytest.raises(ValueError) as terr:
        ours()
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("name", ["Max", "Min"])
def test_max_min_before_an_update_match_jax(name):
    _same(getattr(TM, name)(device=CPU).compute(), getattr(JM, name)().compute())


@pytest.mark.parametrize("name", ["Max", "Min"])
def test_max_min_reject_empty_input_like_jax(name):
    with pytest.raises(ValueError):
        getattr(JM, name)().update(np.zeros(0, np.float32))
    with pytest.raises(ValueError):
        getattr(TM, name)(device=CPU).update(torch.zeros(0))


@pytest.mark.parametrize("name", ["Max", "Min"])
def test_max_min_keep_nan_like_jax(name):
    x = np.array([1.0, np.nan, -3.0], dtype=np.float32)
    _same(getattr(TM, name)(device=CPU).update(x).compute(), getattr(JM, name)().update(x).compute())


# ------------------------------------------------------------ Cat


@pytest.mark.parametrize("dtype", [np.float32, np.int64, np.float16, np.bool_])
def test_cat_matches_jax_bitwise(dtype):
    rng = np.random.default_rng(11)
    tm, jm = TM.Cat(device=CPU), JM.Cat()
    for _ in range(5):
        x = (rng.standard_normal(rng.integers(1, 50)) * 4).astype(dtype)
        tm.update(torch.from_numpy(x))
        jm.update(x)
    _assert_states(tm, jm)
    _same(tm.compute(), jm.compute())


def test_cat_along_dim_one_matches_jax():
    rng = np.random.default_rng(12)
    tm, jm = TM.Cat(dim=1, device=CPU), JM.Cat(dim=1)
    for w in (3, 70, 1):
        x = rng.standard_normal((4, w)).astype(np.float32)
        tm.update(x)
        jm.update(x)
    _assert_states(tm, jm)
    _same(tm.compute(), jm.compute())


def test_cat_before_an_update_matches_jax():
    _same(TM.Cat(device=CPU).compute(), JM.Cat().compute())


def test_cat_merge_keeps_our_dim_and_appends_peers():
    rng = np.random.default_rng(13)
    xs = [rng.standard_normal((2, 5)).astype(np.float32) for _ in range(3)]
    tms = [TM.Cat(dim=1, device=CPU).update(x) for x in xs]
    jms = [JM.Cat(dim=1).update(x) for x in xs]
    tms[0].merge_state(tms[1:])
    jms[0].merge_state(jms[1:])
    _assert_states(tms[0], jms[0])
    _same(tms[0].compute(), np.concatenate(xs, axis=1))


# ------------------------------------------------------------ AUC class


@pytest.mark.parametrize("n_tasks", [1, 3])
@pytest.mark.parametrize("reorder", [True, False])
def test_auc_class_matches_jax(n_tasks, reorder):
    rng = np.random.default_rng(20 + n_tasks)
    tm = TM.AUC(reorder=reorder, n_tasks=n_tasks, device=CPU)
    jm = JM.AUC(reorder=reorder, n_tasks=n_tasks)
    for n in (5, 1, 70, 2):
        shape = (n,) if n_tasks == 1 else (n_tasks, n)
        x = (rng.integers(0, 16, shape) / 4).astype(np.float32)
        y = (rng.integers(0, 16, shape) / 4).astype(np.float32)
        tm.update(torch.from_numpy(x), torch.from_numpy(y))
        jm.update(x, y)
        _assert_states(tm, jm)
        _same(tm.compute(), jm.compute())


def test_auc_class_before_an_update_matches_jax():
    _same(TM.AUC(device=CPU).compute(), JM.AUC().compute())


@pytest.mark.parametrize("x, y, n_tasks", [
    (np.ones(3, np.float32), np.ones(2, np.float32), 1),
    (np.ones((2, 3), np.float32), np.ones((2, 3), np.float32), 1),
    (np.zeros(0, np.float32), np.zeros(0, np.float32), 1),
])
def test_auc_class_bad_updates_raise_like_jax(x, y, n_tasks):
    with pytest.raises(ValueError) as want:
        JM.AUC(n_tasks=n_tasks).update(x, y)
    with pytest.raises(ValueError) as got:
        TM.AUC(n_tasks=n_tasks, device=CPU).update(x, y)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------ state, merge


def _cases():
    rng = np.random.default_rng(30)
    pts = lambda n: ((rng.integers(0, 12, (2, n)) / 4).astype(np.float32),  # noqa: E731
                     (rng.integers(0, 12, (2, n)) / 4).astype(np.float32))
    return {
        "Max": (lambda P, **k: P.Max(**k), lambda: [(x,) for x in _stream(31)]),
        "Min": (lambda P, **k: P.Min(**k), lambda: [(x,) for x in _stream(32)]),
        "Cat": (lambda P, **k: P.Cat(**k), lambda: [(x,) for x in _stream(33)]),
        "AUC": (lambda P, **k: P.AUC(n_tasks=2, **k), lambda: [pts(n) for n in (3, 9, 40, 1, 5, 2)]),
    }


CASES = _cases()
NAMES = sorted(CASES)


@pytest.mark.parametrize("updated", [False, True], ids=["fresh", "updated"])
@pytest.mark.parametrize("name", NAMES)
def test_state_dict_cross_loads_both_ways(name, updated):
    make, batches = CASES[name]
    data = batches()
    jm = make(JM)
    if updated:
        for b in data[:3]:
            jm.update(*b)
    tm = make(TM, device=CPU)
    load_numpy_state_dict(tm, _numpy_sd(jm))
    _assert_states(tm, jm)
    back = make(JM)
    back.load_state_dict(_to_jax(numpy_state_dict(tm)))
    _assert_states(tm, back)
    for b in data[3:]:
        tm.update(*b)
        back.update(*b)
    _assert_states(tm, back)
    _same(tm.compute(), back.compute())


@pytest.mark.parametrize("name", NAMES)
def test_merge_state_matches_jax(name):
    make, batches = CASES[name]
    data = batches()
    tms, jms = [make(TM, device=CPU) for _ in range(3)], [make(JM) for _ in range(3)]
    for i, b in enumerate(data):
        tms[i % 3].update(*b)
        jms[i % 3].update(*b)
    tms[0].merge_state(tms[1:])
    jms[0].merge_state(jms[1:])
    _assert_states(tms[0], jms[0])
    _same(tms[0].compute(), jms[0].compute())


class TestAggregationClasses(MetricClassTester):
    @pytest.mark.parametrize("name", NAMES)
    def test_class_contract(self, name):
        make, batches = CASES[name]
        data = (batches() * 2)[:8]
        keys = ("x", "y") if name == "AUC" else ("input",)
        kwargs = {k: [b[i] for b in data] for i, k in enumerate(keys)}
        whole = make(JM)
        for b in data:
            whole.update(*b)
        ranks = [make(JM) for _ in range(4)]
        for r in range(4):
            for b in data[2 * r:2 * r + 2]:
                ranks[r].update(*b)
        ranks[0].merge_state(ranks[1:])
        self.run_class_implementation_tests(
            metric=make(TM, device=CPU),
            state_names=set(make(JM)._state_name_to_default),
            update_kwargs=kwargs,
            compute_result=np.asarray(whole.compute()),
            merge_and_compute_result=np.asarray(ranks[0].compute()),
            num_total_updates=8,
            num_processes=4,
            atol=0,
            rtol=1e-6,
        )


# ------------------------------------------------------------ random data


def _jax_rand(name, *args):
    return [np.asarray(a) for a in getattr(JU, name)(*args, key=jax.random.PRNGKey(1))]


@pytest.mark.parametrize("name, args", [
    ("get_rand_data_binary", (3, 1, 17)),
    ("get_rand_data_binary", (3, 4, 17)),
    ("get_rand_data_multiclass", (2, 5, 33)),
    ("get_rand_data_multilabel", (2, 6, 9)),
    ("get_rand_data_binned_binary", (2, 3, 21, 11)),
])
def test_random_data_shapes_dtypes_and_ranges_match_jax(name, args):
    got = getattr(TU, name)(*args, generator=torch.Generator().manual_seed(1), device=CPU)
    want = _jax_rand(name, *args)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = _np(g)
        assert g.shape == w.shape and g.dtype == w.dtype, (name, g.shape, g.dtype, w.shape, w.dtype)
    scores = _np(got[0])
    assert scores.min() >= 0.0 and scores.max() < 1.0
    targets = _np(got[1])
    hi = args[1] if name == "get_rand_data_multiclass" else 2
    assert targets.min() >= 0 and targets.max() < hi
    assert len(np.unique(targets)) > 1
    if name == "get_rand_data_binned_binary":
        t = _np(got[2])
        assert t[0] == 0.0 and t[-1] == 1.0 and np.all(np.diff(t) >= 0)


@pytest.mark.parametrize("name, args", [
    ("get_rand_data_binary", (2, 3, 8)),
    ("get_rand_data_multiclass", (2, 5, 8)),
    ("get_rand_data_multilabel", (2, 4, 8)),
    ("get_rand_data_binned_binary", (2, 1, 8, 5)),
])
def test_random_data_is_deterministic_under_one_seed(name, args):
    fn = getattr(TU, name)
    a = fn(*args, generator=torch.Generator().manual_seed(5), device=CPU)
    b = fn(*args, generator=torch.Generator().manual_seed(5), device=CPU)
    c = fn(*args, generator=torch.Generator().manual_seed(6), device=CPU)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], c[0])
    for x, y in zip(a, fn(*args, device=CPU)):  # no generator: seed 0 each call
        assert x.shape == y.shape
    assert all(torch.equal(x, y) for x, y in zip(fn(*args, device=CPU), fn(*args, device=CPU)))


def test_random_data_defaults_to_cuda():
    if torch.cuda.is_available():
        assert TU.get_rand_data_binary(1, 1, 4)[0].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TU.get_rand_data_binary(1, 1, 4)


# ------------------------------------------------------------ surface


_DOC_MODULES = [
    "torcheval_tpu_torch.metrics.functional.aggregation.auc",
    "torcheval_tpu_torch.metrics.functional.aggregation.throughput",
    *[f"torcheval_tpu_torch.metrics.aggregation.{m}" for m in ("auc", "cat", "max", "min")],
]


@pytest.mark.parametrize("module", _DOC_MODULES,
                         ids=lambda m: m.rsplit(".", 2)[-2] + "." + m.rsplit(".", 1)[-1])
def test_docstring_examples_run(module):
    result = doctest.testmod(importlib.import_module(module),
                             optionflags=doctest.NORMALIZE_WHITESPACE)
    assert result.attempted > 0 and result.failed == 0


@pytest.mark.parametrize("name", ["AUC", "Cat", "Max", "Min"])
def test_classes_default_to_cuda(name):
    if torch.cuda.is_available():
        assert getattr(TM, name)().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            getattr(TM, name)()


def test_the_port_exports_the_aggregation_family():
    for name in ("AUC", "Cat", "Max", "Min"):
        assert name in TM.__all__ and name in JM.__all__
    for name in ("auc", "throughput"):
        assert name in TF.__all__ and name in JF.__all__
    for name in ("get_rand_data_binary", "get_rand_data_binned_binary",
                 "get_rand_data_multiclass", "get_rand_data_multilabel"):
        assert name in TU.__all__ and name in JU.__all__


def test_simple_example_trains_and_reports_on_cpu(capsys):
    from torcheval_tpu_torch.examples import simple_example

    out = simple_example.main(["--device", "cpu"])
    assert out["acc"] > 0.8 and 0.0 < out["loss"] < 2.0 and out["tokens_per_s"] > 0
    assert capsys.readouterr().out.count("epoch") == simple_example.EPOCHS
