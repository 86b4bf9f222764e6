"""torcheval_tpu_torch's exact curve family (functional) against the JAX
package on the same numpy inputs, the JAX side run on the CPU as its own
tests run it. ``sort_desc`` and the precision/recall/threshold arrays must
be bitwise equal (their counts are exact integers in float32); AUROC,
AUPRC and recall-at-precision scalars agree within atol 1e-6, because the
two packages reduce in different orders (XLA's CPU cumsum and area
kernels against torch's double-accumulated CPU cumsum)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torcheval_tpu.metrics.functional as JF
from torcheval_tpu.metrics.functional.classification import _curve_kernels as jck
import torcheval_tpu_torch.metrics.functional as TF
from torcheval_tpu_torch.metrics.functional.classification import _curve_kernels as tck

CPU = "cpu"
ATOL = 1e-6


def _tricky(n, seed, dtype=np.float32):
    """Scores with ties, NaN of both signs, +-0 and +-inf."""
    rng = np.random.default_rng(seed)
    x = np.round(rng.standard_normal(n) * 4) / 4  # many ties
    x[:: max(1, n // 7)] = np.nan
    x[1 :: max(1, n // 5)] = -np.nan
    x[2 :: max(1, n // 6)] = -0.0
    x[3 :: max(1, n // 6)] = 0.0
    x[4 :: max(1, n // 9)] = np.inf
    x[5 :: max(1, n // 9)] = -np.inf
    return x.astype(dtype)


def _binary(seed, n=257, tasks=None, ties=True, weights=False):
    rng = np.random.default_rng(seed)
    shape = (n,) if tasks is None else (tasks, n)
    s = rng.random(shape).astype(np.float32)
    if ties:
        s = np.round(s * 16) / 16
    t = (rng.random(shape) < s).astype(np.int64)
    w = rng.random(shape).astype(np.float32) if weights else None
    return s, t, w


# --------------------------------------------------------------- sort_desc


@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.int32])
@pytest.mark.parametrize("shape", [(1,), (97,), (4, 300)])
def test_sort_desc_bitwise_equals_jax(dtype, shape):
    x = _tricky(int(np.prod(shape)), 3, np.float32).reshape(shape)
    if dtype is np.int32:
        x = np.nan_to_num(x * 4, nan=7, posinf=99, neginf=-99).astype(np.int32)
    else:
        x = x.astype(dtype)
    want_s, want_o = jck.sort_desc(jnp.asarray(x))
    got_s, got_o = tck.sort_desc(torch.from_numpy(x))
    np.testing.assert_array_equal(got_o.numpy(), np.asarray(want_o))
    assert got_s.numpy().tobytes() == np.asarray(want_s).tobytes()


def test_sort_desc_nan_last_zero_ties_and_stable():
    x = np.array([0.0, -np.nan, 1.0, -0.0, np.nan, -np.inf, np.inf, 1.0, 0.0], np.float32)
    _, order = tck.sort_desc(torch.from_numpy(x))
    # inf, the two 1.0 in index order, the three zeros in index order,
    # -inf, then both NaN in index order
    assert order.tolist() == [6, 2, 7, 0, 3, 8, 5, 1, 4]


def test_run_end_propagation_matches_jax():
    x = np.sort(_tricky(200, 4))[::-1].copy()
    x = x[~np.isnan(x)]
    values = np.cumsum(np.random.default_rng(5).random(x.size)).astype(np.float32)
    want_end = np.asarray(jck._run_end_mask(jnp.asarray(x)))
    got_end = tck._run_end_mask(torch.from_numpy(x))
    np.testing.assert_array_equal(got_end.numpy(), want_end)
    want = np.asarray(jck._propagate_run_end(jnp.asarray(values), jnp.asarray(want_end)))
    got = tck._propagate_run_end(torch.from_numpy(values), got_end)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(4096,), (4097,), (3, 10_000), (2, 2, 8193)])
def test_two_level_reverse_cummin_is_the_one_level_scan(shape):
    """Past one block the scan runs in two levels; it must give the
    one-level scan's values, NaN and +-inf included (a NaN's payload may
    differ), and follow JAX's reverse cummin where values decrease
    (negative weights)."""
    rng = np.random.default_rng(int(np.prod(shape)))
    x = np.cumsum(rng.standard_normal(shape), axis=-1).astype(np.float32)
    x.reshape(-1)[::13] = np.inf
    x.reshape(-1)[::4999] = np.nan
    x.reshape(-1)[7::3001] = -np.inf
    t = torch.from_numpy(x)
    one_level = torch.flip(torch.cummin(torch.flip(t, (-1,)), -1).values, (-1,))
    got = tck._reverse_cummin(t)
    np.testing.assert_array_equal(got.numpy(), one_level.numpy())
    want = np.flip(np.asarray(jax.lax.cummin(jnp.flip(jnp.asarray(x), -1), axis=x.ndim - 1)), -1)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("tasks", [None, 3])
def test_roc_cumulators_bitwise_on_unit_weights(tasks):
    s, t, _ = _binary(6, tasks=tasks)
    want = jck.roc_cumulators(jnp.asarray(s), jnp.asarray(t))
    got = tck.roc_cumulators(torch.from_numpy(s), torch.from_numpy(t))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("tasks", [None, 3])
@pytest.mark.parametrize("pos_label", [1, 0])
def test_prc_arrays_bitwise(tasks, pos_label):
    s, t, _ = _binary(7, tasks=tasks)
    s.reshape(-1)[::11] = np.nan
    want = jck.prc_arrays(jnp.asarray(s), jnp.asarray(t), pos_label)
    got = tck.prc_arrays(torch.from_numpy(s), torch.from_numpy(t), pos_label)
    for g, w in zip(got, want):
        assert g.numpy().tobytes() == np.asarray(w).tobytes()


# --------------------------------------------------------------- AUROC


@pytest.mark.parametrize(
    "tasks,weights,ties",
    [(None, False, True), (None, True, True), (None, False, False), (3, False, True), (3, True, True)],
)
def test_binary_auroc_matches_jax(tasks, weights, ties):
    s, t, w = _binary(8, n=1000, tasks=tasks, ties=ties, weights=weights)
    kw = {} if tasks is None else {"num_tasks": tasks}
    want = JF.binary_auroc(s, t, weight=w, **kw)
    got = TF.binary_auroc(torch.from_numpy(s), torch.from_numpy(t),
                          weight=None if w is None else torch.from_numpy(w), **kw)
    assert got.shape == np.asarray(want).shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_binary_auroc_degenerate_tasks_are_half():
    s = np.array([[0.1, 0.4, 0.9], [0.3, 0.2, 0.8]], np.float32)
    t = np.array([[1, 1, 1], [0, 0, 0]])
    got = TF.binary_auroc(s, t, num_tasks=2, device=CPU)
    np.testing.assert_array_equal(got.numpy(), np.asarray(JF.binary_auroc(s, t, num_tasks=2)))
    assert got.tolist() == [0.5, 0.5]


@pytest.mark.parametrize("tasks", [None, 3])
@pytest.mark.parametrize("alias", ["use_fused", "use_fbgemm"])
def test_binary_auroc_fused_plain_histogram_matches_jax(tasks, alias):
    s, t, w = _binary(9, n=3000, tasks=tasks, ties=False, weights=True)
    kw = {} if tasks is None else {"num_tasks": tasks}
    want = JF.binary_auroc(s, t, weight=w, use_fused=True, **kw)
    got = TF.binary_auroc(torch.from_numpy(s), torch.from_numpy(t), weight=torch.from_numpy(w),
                          **{alias: True}, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("average", ["macro", None, "none"])
def test_multiclass_auroc_matches_jax(average):
    rng = np.random.default_rng(10)
    x = np.round(rng.random((400, 7)) * 8).astype(np.float32) / 8
    y = rng.integers(0, 7, 400)
    want = JF.multiclass_auroc(x, y, num_classes=7, average=average)
    got = TF.multiclass_auroc(torch.from_numpy(x), torch.from_numpy(y), num_classes=7, average=average)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


# --------------------------------------------------------------- AUPRC


@pytest.mark.parametrize("tasks", [None, 1, 4])
def test_binary_auprc_matches_jax(tasks):
    s, t, _ = _binary(11, n=700, tasks=tasks)
    kw = {} if tasks is None else {"num_tasks": tasks}
    want = JF.binary_auprc(s, t, **kw)
    got = TF.binary_auprc(torch.from_numpy(s), torch.from_numpy(t), **kw)
    assert got.shape == np.asarray(want).shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("average", ["macro", None])
def test_multiclass_and_multilabel_auprc_match_jax(average):
    rng = np.random.default_rng(12)
    x = np.round(rng.random((300, 5)) * 10).astype(np.float32) / 10
    y = rng.integers(0, 5, 300)
    yl = (rng.random((300, 5)) < x).astype(np.int64)
    np.testing.assert_allclose(
        TF.multiclass_auprc(torch.from_numpy(x), torch.from_numpy(y), num_classes=5, average=average).numpy(),
        np.asarray(JF.multiclass_auprc(x, y, num_classes=5, average=average)), atol=ATOL)
    np.testing.assert_allclose(
        TF.multilabel_auprc(torch.from_numpy(x), torch.from_numpy(yl), num_labels=5, average=average).numpy(),
        np.asarray(JF.multilabel_auprc(x, yl, num_labels=5, average=average)), atol=ATOL)


# ------------------------------------------------------ precision-recall curve


def _assert_curve_bitwise(got, want):
    for g, w in zip(got, want):
        assert g.numpy().tobytes() == np.asarray(w).tobytes()


def test_binary_precision_recall_curve_bitwise():
    s, t, _ = _binary(13, n=500)
    _assert_curve_bitwise(TF.binary_precision_recall_curve(torch.from_numpy(s), torch.from_numpy(t)),
                          JF.binary_precision_recall_curve(s, t))


def test_multiclass_and_multilabel_precision_recall_curves_bitwise():
    rng = np.random.default_rng(14)
    x = np.round(rng.random((200, 4)) * 6).astype(np.float32) / 6
    y = rng.integers(0, 4, 200)
    yl = (rng.random((200, 4)) < x).astype(np.int64)
    got = TF.multiclass_precision_recall_curve(torch.from_numpy(x), torch.from_numpy(y), num_classes=4)
    want = JF.multiclass_precision_recall_curve(x, y, num_classes=4)
    for g, w in zip(got, want):
        _assert_curve_bitwise(g, w)
    got = TF.multilabel_precision_recall_curve(torch.from_numpy(x), torch.from_numpy(yl))
    want = JF.multilabel_precision_recall_curve(x, yl)
    for g, w in zip(got, want):
        _assert_curve_bitwise(g, w)


# ---------------------------------------------------- recall at fixed precision


@pytest.mark.parametrize("min_precision", [0.0, 0.3, 0.5, 0.9, 1.0])
def test_binary_recall_at_fixed_precision_matches_jax(min_precision):
    s, t, _ = _binary(15, n=400)
    s = s * 4 - 2  # negative thresholds must not be shadowed by the -1 terminal
    want = JF.binary_recall_at_fixed_precision(s, t, min_precision=min_precision)
    got = TF.binary_recall_at_fixed_precision(torch.from_numpy(s), torch.from_numpy(t),
                                              min_precision=min_precision)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


@pytest.mark.parametrize("scores,threshold", [([0.9, 0.8, 0.7, 0.6], 0.9), ([-3.0, -4.0, -5.0, -6.0], 1.0)])
def test_recall_at_unreachable_precision(scores, threshold):
    """No point reaches precision 1: recall 0, at the top score, or at the
    terminal point's threshold 1 when every score is below -1."""
    s = np.array(scores, np.float32)
    t = np.array([0, 1, 0, 1])
    got = TF.binary_recall_at_fixed_precision(s, t, min_precision=1.0, device=CPU)
    want = JF.binary_recall_at_fixed_precision(s, t, min_precision=1.0)
    assert [float(v) for v in got] == [float(v) for v in want] == [0.0, float(np.float32(threshold))]


@pytest.mark.parametrize("min_precision", [0.0, 0.5, 1.0])
def test_multilabel_recall_at_fixed_precision_matches_jax(min_precision):
    rng = np.random.default_rng(16)
    x = np.round(rng.random((150, 3)) * 8).astype(np.float32) / 8
    yl = (rng.random((150, 3)) < x).astype(np.int64)
    got = TF.multilabel_recall_at_fixed_precision(torch.from_numpy(x), torch.from_numpy(yl),
                                                  num_labels=3, min_precision=min_precision)
    want = JF.multilabel_recall_at_fixed_precision(x, yl, num_labels=3, min_precision=min_precision)
    for g_list, w_list in zip(got, want):
        assert len(g_list) == len(w_list) == 3
        for g, w in zip(g_list, w_list):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


@pytest.mark.parametrize("bad", [1, 1.5, -0.1])
def test_min_precision_is_checked(bad):
    with pytest.raises(ValueError, match="min_precision"):
        TF.binary_recall_at_fixed_precision(np.ones(3, np.float32), np.ones(3), min_precision=bad,
                                            device=CPU)


# ------------------------------------------------------------ input checks


def test_input_checks_match_jax_messages():
    s = np.ones((2, 3), np.float32)
    for fn, kw in ((JF.binary_auroc, {}), (TF.binary_auroc, {"device": CPU})):
        with pytest.raises(ValueError, match="num_tasks = 1"):
            fn(s, s, **kw)
    for fn, kw in ((JF.multiclass_auroc, {}), (TF.multiclass_auroc, {"device": CPU})):
        with pytest.raises(ValueError, match="num_classes"):
            fn(s, np.ones(2), num_classes=1, **kw)
    with pytest.raises(ValueError, match="one-dimensional"):
        TF.binary_precision_recall_curve(s, s, device=CPU)


def test_float64_and_int64_inputs_compute_in_32_bits():
    """The JAX package holds float64/int64 inputs as float32/int32, so
    the port narrows them: the same values as float32 input."""
    s, t, _ = _binary(17, n=300)
    s64 = torch.from_numpy(s.astype(np.float64))
    a = TF.binary_auroc(s64, torch.from_numpy(t))
    b = TF.binary_auroc(torch.from_numpy(s), torch.from_numpy(t).to(torch.int32))
    assert a.dtype == torch.float32 and torch.equal(a, b)
