"""torcheval_tpu_torch's ops layer (segment sum/count/max, histogram,
bincount, top-k) and the threshold helpers of ``tensor_utils`` against the
JAX package on the same numpy inputs, the JAX side run both through its
XLA twins under ``jax.jit`` (what the TPU runs) and through its public
dispatchers (the native CPU kernels).

Tolerances: integer results and integer-valued float sums are bitwise
equal; sums of random float32 weights agree within rtol 1e-6 (the two
packages add in different orders); ``topk`` values and indices are
bitwise equal; gradients agree within rtol 1e-6. 64-bit inputs are held to
numpy, not to the JAX package's x64 paths.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torcheval_tpu.metrics.functional import tensor_utils as jtu
from torcheval_tpu.ops import bincount as jbincount
from torcheval_tpu.ops import histogram as jhistogram
from torcheval_tpu.ops import segment as jseg
from torcheval_tpu.ops import segment_count as jsegment_count
from torcheval_tpu.ops import segment_max as jsegment_max
from torcheval_tpu.ops import segment_sum as jsegment_sum
from torcheval_tpu.ops import topk as jtopk
from torcheval_tpu.ops.histogram import _histogram_xla
import torcheval_tpu_torch.ops as tops
from torcheval_tpu_torch.metrics.functional import tensor_utils as ttu
from torcheval_tpu_torch.ops.histogram import _bin_scale
from torcheval_tpu_torch.ops.segment import safe_ids

RTOL = 1e-6



def _same(got, want) -> None:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes(), (got, want)


def _ids(rng, n, segments, dtype=np.int32):
    """Ids mostly in range, with a sprinkling of negative and too-large
    ones (dropped by every op)."""
    ids = rng.integers(0, segments, n)
    bad = rng.random(n) < 0.1
    ids[bad] = rng.choice([-1, -7, segments, segments + 5], bad.sum())
    return ids.astype(dtype)


# --------------------------------------------------------------- segment


SEGMENT_CASES = [(0, 5), (1, 1), (17, 4), (500, 33), (3000, 7)]


@pytest.mark.parametrize("n, segments", SEGMENT_CASES)
@pytest.mark.parametrize("kind", ["integer_valued", "random", "nan"])
def test_segment_sum_matches_jax(n, segments, kind):
    rng = np.random.default_rng(n + segments)
    ids = _ids(rng, n, segments)
    if kind == "integer_valued":
        data = rng.integers(-3, 4, n).astype(np.float32)
    else:
        data = rng.standard_normal(n).astype(np.float32)
    if kind == "nan" and n:
        data[::5] = np.nan  # poisons only its own segment (or nothing, if dropped)
    got = tops.segment_sum(torch.from_numpy(data), torch.from_numpy(ids), segments)
    xla = jax.jit(lambda d, i: jseg._segment_sum_xla(d, i, segments))(data, ids)
    native = jsegment_sum(jnp.asarray(data), jnp.asarray(ids), segments)
    for want in (xla, native):
        if kind == "integer_valued":
            _same(got, want)
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-6)
            np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(np.asarray(want)))


def test_segment_sum_rows_of_2d_data_match_jax():
    rng = np.random.default_rng(0)
    data = rng.integers(-5, 5, (40, 3)).astype(np.float32)
    ids = _ids(rng, 40, 6)
    got = tops.segment_sum(torch.from_numpy(data), torch.from_numpy(ids), 6)
    _same(got, jax.ops.segment_sum(jnp.asarray(data), jnp.asarray(ids), num_segments=6))


def test_segment_sum_int64_ids_past_2_31_are_dropped():
    """An id past 2^31 must not wrap into range (numpy oracle: x64 is off
    in the JAX package)."""
    ids = np.array([1, 2**31 + 1, 2**32 + 2, -(2**32) + 3, 3], dtype=np.int64)
    data = np.ones(5, dtype=np.float32)
    got = tops.segment_sum(torch.from_numpy(data), torch.from_numpy(ids), 4)
    _same(got, np.array([0, 1, 0, 1], dtype=np.float32))
    _same(tops.segment_count(torch.from_numpy(ids), 4), np.array([0, 1, 0, 1], dtype=np.int32))


@pytest.mark.parametrize("n, segments", SEGMENT_CASES)
@pytest.mark.parametrize("mask", [None, "bool", "fractional"])
def test_segment_count_matches_jax(n, segments, mask):
    rng = np.random.default_rng(7 * n + segments)
    ids = _ids(rng, n, segments)
    m = None
    if mask == "bool":
        m = rng.random(n) < 0.7
    elif mask == "fractional":
        m = (rng.random(n) * (rng.random(n) < 0.6)).astype(np.float32)  # 0 or in (0, 1)
    got = tops.segment_count(torch.from_numpy(ids), segments,
                             None if m is None else torch.from_numpy(m))
    jm = None if m is None else jnp.asarray(m)
    _same(got, jax.jit(lambda i, mm: jseg._segment_count_xla(i, segments, mm))(ids, jm))
    _same(got, jsegment_count(jnp.asarray(ids), segments, jm))


@pytest.mark.parametrize("identity", [0, -5, 40])
@pytest.mark.parametrize("n, segments", SEGMENT_CASES)
def test_segment_max_matches_jax(n, segments, identity):
    rng = np.random.default_rng(n * 3 + identity + 10)
    ids = _ids(rng, n, segments)
    data = rng.integers(-20, 60, n).astype(np.int32)
    got = tops.segment_max(torch.from_numpy(data), torch.from_numpy(ids), segments,
                           identity=identity)
    xla = jax.jit(lambda d, i: jseg._segment_max_xla(d, i, segments, identity))(data, ids)
    native = jsegment_max(jnp.asarray(data), jnp.asarray(ids), segments, identity=identity)
    _same(got, xla)
    _same(got, native)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_safe_ids_matches_jax(dtype):
    ids = np.array([-3, -1, 0, 4, 5, 9, 2], dtype=dtype)
    _same(safe_ids(torch.from_numpy(ids), 5), jseg.safe_ids(jnp.asarray(ids), 5))


def test_segment_sum_moved_to_ops_and_reexported():
    assert ttu.segment_sum is tops.segment_sum


# -------------------------------------------------------------- histogram


HIST_BOUNDS = [(0.0, 1.0), (-1.3, 2.9), (-3.0, 5.0), (0.1, 0.7)]


def _hist_values(rng, lo, hi, num_bins, n=3000):
    """Random samples, every bin edge and its float32 neighbours, values
    past both bounds, NaN and +-inf (no denormals: XLA flushes them)."""
    edges = np.float32(lo) + np.arange(num_bins + 1) * ((hi - lo) / num_bins)
    edges = edges.astype(np.float32)
    v = np.concatenate([
        rng.uniform(lo, hi, n).astype(np.float32),
        edges, np.nextafter(edges, np.float32(np.inf)), np.nextafter(edges, np.float32(-np.inf)),
        np.float32([lo - 1, hi + 1, np.nan, -np.nan, np.inf, -np.inf, lo, hi]),
    ]).astype(np.float32)
    tiny = np.finfo(np.float32).tiny
    return v[(np.abs(v) >= tiny) | (v == 0) | ~np.isfinite(v)]


@pytest.mark.parametrize("num_bins", [1, 7, 100, 1000])
@pytest.mark.parametrize("bounds", HIST_BOUNDS)
def test_histogram_bitwise_equals_jitted_xla_twin(bounds, num_bins):
    """The TPU's semantics: ``_histogram_xla`` under ``jax.jit``, bitwise on
    unit weights (including the edge samples of bounds whose span is not a
    power of two)."""
    v = _hist_values(np.random.default_rng(num_bins), *bounds, num_bins)
    got = tops.histogram(torch.from_numpy(v), num_bins, bounds=bounds)
    want = jax.jit(lambda x: _histogram_xla(x, None, num_bins, *bounds))(v)
    _same(got, want)


@pytest.mark.parametrize("bounds", HIST_BOUNDS)
def test_histogram_weighted_matches_jax(bounds):
    rng = np.random.default_rng(3)
    v = _hist_values(rng, *bounds, 50)
    w = rng.random(v.shape).astype(np.float32)
    got = tops.histogram(torch.from_numpy(v), 50, bounds=bounds, weights=torch.from_numpy(w))
    want = jax.jit(lambda x, ww: _histogram_xla(x, ww, 50, *bounds))(v, w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


@pytest.mark.parametrize("bounds", [(-3.0, 5.0), (0.0, 1.0), (-0.5, 1.5)])
def test_histogram_equals_native_path_on_dyadic_spans(bounds):
    """Where ``1 / span`` is exact the native CPU kernel's divide and the
    XLA reciprocal multiply agree, and so does the port."""
    v = _hist_values(np.random.default_rng(5), *bounds, 64)
    got = tops.histogram(torch.from_numpy(v), 64, bounds=bounds)
    _same(got, jhistogram(jnp.asarray(v), 64, bounds=bounds))


def test_histogram_follows_xla_not_native_on_non_dyadic_spans():
    """On (-1.3, 2.9) the native kernel divides and the XLA twin
    multiplies by the folded reciprocal: edge samples land one bin apart
    between them, and the port is the XLA twin's."""
    bounds, num_bins = (-1.3, 2.9), 1000
    v = _hist_values(np.random.default_rng(11), *bounds, num_bins)
    got = tops.histogram(torch.from_numpy(v), num_bins, bounds=bounds)
    native = np.asarray(jhistogram(jnp.asarray(v), num_bins, bounds=bounds))
    xla = np.asarray(jax.jit(lambda x: _histogram_xla(x, None, num_bins, *bounds))(v))
    assert not np.array_equal(native, xla)  # the reference-side split this pins
    _same(got, xla)
    lo32, hi32, scale32 = _bin_scale(*bounds, num_bins)
    assert scale32 == np.float32(np.float32(1.0) / np.float32(4.2)) * np.float32(num_bins)


def test_histogram_checks_match_jax():
    v = torch.zeros(4)
    for kwargs in ({"num_bins": 0, "bounds": (0, 1)}, {"num_bins": 3, "bounds": (1, 1)}):
        with pytest.raises(ValueError):
            tops.histogram(v, **kwargs)
        with pytest.raises(ValueError):
            jhistogram(jnp.zeros(4), **kwargs)
    with pytest.raises(ValueError, match="weights shape"):
        tops.histogram(v, 3, bounds=(0, 1), weights=torch.ones(3))


def test_histogram_empty_input_is_zero():
    got = tops.histogram(torch.zeros(0), 5, bounds=(0.0, 1.0))
    _same(got, np.zeros(5, np.float32))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.uint8])
def test_bincount_matches_jax(dtype, weighted):
    rng = np.random.default_rng(9)
    ids = rng.integers(0, 12, 400).astype(dtype)
    if dtype != np.uint8:
        ids[::9] = -2
    ids[::13] = 12 if dtype != np.uint8 else 200
    w = rng.integers(0, 5, 400).astype(np.float32) if weighted else None
    got = tops.bincount(torch.from_numpy(ids), 10, weights=None if w is None else torch.from_numpy(w))
    want = jbincount(jnp.asarray(ids), 10, weights=None if w is None else jnp.asarray(w))
    _same(got, want)


def test_bincount_refuses_float_ids():
    with pytest.raises(ValueError, match="integers"):
        tops.bincount(torch.zeros(3), 4)


# ------------------------------------------------------------------- topk


def _tricky_rows(rng, rows, n):
    x = np.round(rng.standard_normal((rows, n)) * 3).astype(np.float32) / 4  # ties
    specials = np.float32([np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf])
    for r in range(rows):
        pos = rng.choice(n, size=min(n, 2 * len(specials)), replace=False)
        x[r, pos] = np.resize(specials, len(pos))
    return x


def _total_order_oracle(x, k):
    """numpy top-k by IEEE totalOrder, ties by ascending index: sort the
    sign-magnitude integer keys of the bits."""
    if x.dtype.kind == "f":
        ibits = {2: np.int16, 4: np.int32, 8: np.int64}[x.dtype.itemsize]
        b = x.view(ibits).astype(np.int64)
        flip = np.int64(np.iinfo(ibits).max)
        key = np.where(b < 0, b ^ flip, b)
    else:
        key = x.astype(np.int64)
    order = np.argsort(-key, axis=-1, kind="stable")[..., :k]
    return np.take_along_axis(x, order, -1), order.astype(np.int32)


@pytest.mark.parametrize("k", [0, 1, 3, 9, 24])
@pytest.mark.parametrize("shape", [(24,), (5, 24), (2, 3, 24)])
def test_topk_bitwise_equals_lax_top_k(shape, k):
    x = _tricky_rows(np.random.default_rng(k), int(np.prod(shape[:-1])), shape[-1]).reshape(shape)
    vals, idx = tops.topk(torch.from_numpy(x), k)
    for want_vals, want_idx in (jax.lax.top_k(jnp.asarray(x), k), jtopk(jnp.asarray(x), k)):
        _same(vals, want_vals)
        _same(idx, want_idx)
    ov, oi = _total_order_oracle(x, k)
    _same(vals, ov)
    _same(idx, oi)


def test_topk_pins_nan_signs_zero_signs_and_ties():
    """+NaN first, then +inf, ..., +0 above -0, ..., -inf, -NaN last; ties
    by ascending index (the JAX package's pins plus a -NaN row)."""
    x = np.float32([1.0, np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf, 1.0, -0.0, 0.0])
    assert np.signbit(x[2]) and np.isnan(x[2])
    vals, idx = tops.topk(torch.from_numpy(x), 10)
    assert idx.tolist() == [1, 5, 0, 7, 3, 9, 4, 8, 6, 2]
    _same(vals, jax.lax.top_k(jnp.asarray(x), 10)[0])
    neg_nan_row = np.float32([-np.nan, -np.nan, -1.0, -np.nan])
    vals, idx = tops.topk(torch.from_numpy(neg_nan_row), 4)
    assert idx.tolist() == [2, 0, 1, 3]
    _same(idx, jax.lax.top_k(jnp.asarray(neg_nan_row), 4)[1])


@pytest.mark.parametrize("dtype", [np.int32, np.int16, np.float16])
def test_topk_other_dtypes_match_jax(dtype):
    rng = np.random.default_rng(4)
    if dtype == np.float16:
        x = _tricky_rows(rng, 6, 40).astype(np.float16)
    else:
        x = rng.integers(-4, 4, (6, 40)).astype(dtype)
    vals, idx = tops.topk(torch.from_numpy(x), 7)
    want_vals, want_idx = jax.lax.top_k(jnp.asarray(x), 7)
    _same(vals, want_vals)
    _same(idx, want_idx)


@pytest.mark.parametrize("dtype", [np.float64, np.int64])
def test_topk_64_bit_matches_numpy_total_order(dtype):
    rng = np.random.default_rng(8)
    if dtype == np.float64:
        x = _tricky_rows(rng, 4, 33).astype(np.float64)
    else:
        x = rng.integers(-(2**40), 2**40, (4, 33)).astype(np.int64)
        x[:, ::4] = 7  # ties
    vals, idx = tops.topk(torch.from_numpy(x), 11)
    ov, oi = _total_order_oracle(x, 11)
    _same(vals, ov)
    _same(idx, oi)


def test_topk_empty_and_bad_k():
    vals, idx = tops.topk(torch.zeros(3, 0), 0)
    assert vals.shape == (3, 0) and idx.shape == (3, 0) and idx.dtype == torch.int32
    for k in (-1, 4):
        with pytest.raises(ValueError, match="k must be in"):
            tops.topk(torch.zeros(3), k)
        with pytest.raises(ValueError, match="k must be in"):
            jtopk(jnp.zeros(3), k)


# --------------------------------------------------------------- gradients


def test_segment_sum_gradient_matches_jax_grad():
    rng = np.random.default_rng(2)
    data = rng.standard_normal(60).astype(np.float32)
    ids = _ids(rng, 60, 7)
    w = rng.standard_normal(7).astype(np.float32)
    d = torch.from_numpy(data).requires_grad_()
    (tops.segment_sum(d, torch.from_numpy(ids), 7) * torch.from_numpy(w)).sum().backward()
    want = jax.grad(lambda x: jnp.sum(jsegment_sum(x, jnp.asarray(ids), 7) * w))(jnp.asarray(data))
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(want), rtol=RTOL)


def test_histogram_gradient_matches_jax_grad():
    rng = np.random.default_rng(6)
    v = rng.uniform(-1.5, 3.2, 200).astype(np.float32)
    wts = rng.random(200).astype(np.float32)
    c = rng.standard_normal(9).astype(np.float32)
    vt = torch.from_numpy(v).requires_grad_()
    wt = torch.from_numpy(wts).requires_grad_()
    (tops.histogram(vt, 9, bounds=(-1.3, 2.9), weights=wt) * torch.from_numpy(c)).sum().backward()
    gv, gw = jax.grad(
        lambda a, b: jnp.sum(jhistogram(a, 9, bounds=(-1.3, 2.9), weights=b) * c), argnums=(0, 1)
    )(jnp.asarray(v), jnp.asarray(wts))
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw), rtol=RTOL)
    assert vt.grad is None or not vt.grad.any()  # piecewise constant in the values
    assert not np.asarray(gv).any()


def test_topk_gradient_matches_jax_grad():
    rng = np.random.default_rng(12)
    x = rng.standard_normal((3, 20)).astype(np.float32)
    c = rng.standard_normal((3, 5)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    (tops.topk(xt, 5)[0] * torch.from_numpy(c)).sum().backward()
    want = jax.grad(lambda a: jnp.sum(jtopk(a, 5)[0] * c))(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=RTOL)


# ------------------------------------------------------ tensor_utils helpers


@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 7, 100, 101, 200, 1001, 4097, 1 << 16, 1 << 20])
def test_linspace_grid_bitwise_equals_jax(n):
    _same(ttu.create_threshold_tensor(n), jtu.create_threshold_tensor(n))


@pytest.mark.parametrize("threshold", [
    [0.0, 0.3, 0.3, 1.0], np.float32([0.0, 0.1, 0.9]), [0.25], [0.5, 0.2], [[0.1, 0.2]],
    [-0.1, 0.5], [0.2, 1.5], [0.1, 1.0], [0.0, 0.9], 1, 0,
])
@pytest.mark.parametrize("span", [False, True])
def test_create_threshold_tensor_matches_jax(threshold, span):
    try:
        want = jtu.create_threshold_tensor(threshold, span=span)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(",")[0][:30]):
            ttu.create_threshold_tensor(threshold, span=span)
        return
    _same(ttu.create_threshold_tensor(threshold, span=span), want)
    _same(ttu.create_threshold_tensor(torch.tensor(np.asarray(threshold, np.float32)), span=span)
          if not isinstance(threshold, int) else ttu.create_threshold_tensor(threshold, span=span),
          want)


def test_valid_mask_riemann_and_trapezoid_match_jax():
    _same(ttu.valid_mask(7, 3), jtu.valid_mask(7, 3))
    rng = np.random.default_rng(1)
    x = np.sort(rng.random((3, 40)).astype(np.float32), axis=-1)[:, ::-1].copy()
    y = rng.random((3, 40)).astype(np.float32)
    np.testing.assert_allclose(ttu.riemann_integral(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
                               np.asarray(jtu.riemann_integral(x, y)), rtol=RTOL)
    for dim in (-1, 0):
        np.testing.assert_allclose(
            ttu.trapezoid(torch.from_numpy(y), torch.from_numpy(x), dim=dim).numpy(),
            np.asarray(jtu.trapezoid(y, x, axis=dim)), rtol=RTOL)


def test_searchsorted_right_matches_jnp_searchsorted():
    """NaN of either sign past the grid, -0.0 tied with +0.0, +-inf at the
    ends, and values equal to a threshold counted at it."""
    thr = np.float32([0.0, 0.25, 0.25, 0.5, 1.0])
    q = np.float32([np.nan, -np.nan, -0.0, 0.0, -1e-30, 0.25, 0.2500001, 1.0, 2.0,
                    -np.inf, np.inf, 0.7])
    got = ttu.searchsorted_right(torch.from_numpy(thr), torch.from_numpy(q.reshape(3, 4)))
    want = jax.jit(lambda a, b: jnp.searchsorted(a, b, side="right"))(thr, q.reshape(3, 4))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
