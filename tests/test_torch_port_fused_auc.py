"""torcheval_tpu_torch fused-AUC histogram (the CPU path: the plain
version of the Hopper kernel) against the JAX package's ``xla`` backend
and its Pallas kernel in interpret mode, on the same numpy inputs.

Bins must agree exactly. With unit or dyadic weights every bin sum is
exact in any order, so the histograms are bitwise equal; with arbitrary
float32 weights the Pallas kernel sums in another order (one MXU
contraction per 1024-sample chunk), so those compare at rtol 1e-5 with the
total mass conserved at rtol 1e-5."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torcheval_tpu.ops import fused_auc as jax_fused_auc
from torcheval_tpu.ops import fused_auc_histogram as jax_hist
from torcheval_tpu.ops.fused_auc import (
    _auc_from_hist as jax_auc_from_hist,
    _auprc_from_hist as jax_auprc_from_hist,
    _histogram_xla,
    _normalize_scores as jax_normalize,
)
from torcheval_tpu_torch.ops import fused_auc, fused_auc_histogram
from torcheval_tpu_torch.ops.fused_auc import (
    _auc_from_hist,
    _auprc_from_hist,
    _histogram_cuda,
    _histogram_plain,
    _normalize_scores,
    fused_auc_histogram_accumulate,
)

CPU = "cpu"
BINS = 512  # keeps the interpret-mode Pallas grid small


def _data(seed, shape, lo=0.0, hi=1.0, weights="none"):
    rng = np.random.default_rng(seed)
    u = rng.random(shape).astype(np.float32)
    s = (lo + u * (hi - lo) * 1.25 - (hi - lo) * 0.125).astype(np.float32)
    t = (rng.random(shape) < u).astype(np.float32)
    if weights == "none":
        w = None
    elif weights == "dyadic":
        w = (rng.integers(1, 9, shape) / 4.0).astype(np.float32)
    else:
        w = rng.random(shape).astype(np.float32)
    return s, t, w


def _port(s, t, w, **kw):
    tw = None if w is None else torch.from_numpy(w)
    return fused_auc_histogram(
        torch.from_numpy(s), torch.from_numpy(t), tw, **kw
    ).numpy()


BOUNDS = [(0.0, 1.0), (-3.0, 5.0), (-1.3, 2.9), None]
SHAPES = [(4097,), (3, 4097)]


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("bounds", BOUNDS, ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("weights", ["none", "dyadic"])
def test_histogram_bitwise_on_exact_weights(backend, bounds, shape, weights):
    lo, hi = bounds if bounds is not None else (-40.0, 40.0)
    s, t, w = _data(1, shape, lo, hi, weights)
    got = _port(s, t, w, num_bins=BINS, bounds=bounds)
    want = np.asarray(jax_hist(s, t, w, backend=backend, num_bins=BINS, bounds=bounds))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("bounds", [(0.0, 1.0), None], ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_histogram_random_weights_within_tolerance(backend, bounds, shape):
    s, t, w = _data(2, shape, weights="random")
    got = _port(s, t, w, num_bins=BINS, bounds=bounds)
    want = np.asarray(jax_hist(s, t, w, backend=backend, num_bins=BINS, bounds=bounds))
    np.testing.assert_array_equal(got != 0, want != 0)  # same bins occupied
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got.sum(), w.astype(np.float64).sum(), rtol=1e-5)


def test_histogram_plain_matches_histogram_xla_bitwise():
    """The plain version mirrors _histogram_xla on already-normalized
    scores; both add in sample order on the CPU, so even arbitrary
    weights agree bit for bit."""
    s, t, w = _data(3, (2, 3000), weights="random")
    s01 = np.clip(s, 0, 1)
    want = np.asarray(_histogram_xla(jnp.asarray(s01), jnp.asarray(t), jnp.asarray(w), 256))
    got = _histogram_plain(
        torch.from_numpy(s01), torch.from_numpy(t), torch.from_numpy(w), 256
    ).numpy()
    np.testing.assert_array_equal(got, want)


def test_normalize_scores_matches_jax():
    s, _, _ = _data(4, (3, 1000), -7.0, 11.0)
    s[1] = 2.5  # constant task -> 0.5
    want = np.asarray(jax_normalize(jnp.asarray(s)))
    np.testing.assert_array_equal(_normalize_scores(torch.from_numpy(s)).numpy(), want)


@pytest.mark.parametrize("shape", [(0,), (2, 0)], ids=str)
def test_empty_input_gives_zero_histogram(shape):
    h = _port(np.zeros(shape, np.float32), np.zeros(shape, np.float32), None, num_bins=64)
    assert h.shape == ((1 if len(shape) == 1 else 2), 2, 64)
    assert h.sum() == 0.0
    assert float(fused_auc(torch.zeros(0), torch.zeros(0))) == 0.5


def test_nan_scores_land_in_bin_zero_under_fixed_bounds():
    s = np.array([np.nan, 0.5, np.nan, 0.9], np.float32)
    t = np.array([1.0, 0.0, 0.0, 1.0], np.float32)
    got = _port(s, t, None, num_bins=8, bounds=(0.0, 1.0))
    assert got[0, 0, 0] == 1.0 and got[0, 1, 0] == 1.0
    for backend in ("xla", "pallas"):
        want = np.asarray(jax_hist(s, t, backend=backend, num_bins=8, bounds=(0.0, 1.0)))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pos", [0, 1, 3])
def test_nan_scores_poison_the_task_without_bounds(pos):
    s = np.array([[0.2, 0.5, 0.9, 0.1], [0.3, 0.6, 0.7, 0.2]], np.float32)
    s[0, pos] = np.nan
    t = np.array([[1.0, 0.0, 1.0, 0.0]] * 2, np.float32)
    got = _port(s, t, None, num_bins=16)
    want = np.asarray(jax_hist(s, t, backend="xla", num_bins=16))
    np.testing.assert_array_equal(got, want)
    assert got[0, :, 8].sum() == 4.0  # the whole NaN task sits in the 0.5 bin
    auc = fused_auc(torch.from_numpy(s), torch.from_numpy(t)).numpy()
    assert auc[0] == 0.5
    np.testing.assert_allclose(auc, np.asarray(jax_fused_auc(s, t, backend="xla")), atol=1e-6)


def test_1d_weight_broadcasts_over_tasks():
    s, t, _ = _data(5, (3, 1000))
    w = (np.random.default_rng(6).integers(1, 5, 1000) / 2.0).astype(np.float32)
    got = _port(s, t, w, num_bins=BINS, bounds=(0.0, 1.0))
    want = np.asarray(jax_hist(s, t, w, backend="xla", num_bins=BINS, bounds=(0.0, 1.0)))
    np.testing.assert_array_equal(got, want)


def test_1d_target_broadcasts_over_tasks():
    s, t, _ = _data(7, (2, 800))
    got = _port(s, t[0], None, num_bins=BINS)
    want = np.asarray(jax_hist(s, t[0], backend="xla", num_bins=BINS))
    np.testing.assert_array_equal(got, want)


def test_accumulate_matches_oneshot_and_jax():
    s, t, _ = _data(8, (2, 3000))
    h = torch.zeros((2, 2, 256))
    jh = jnp.zeros((2, 2, 256), jnp.float32)
    from torcheval_tpu.ops.fused_auc import fused_auc_histogram_accumulate as jax_acc

    for lo, hi in ((0, 1000), (1000, 3000)):
        h = fused_auc_histogram_accumulate(
            h, torch.from_numpy(s[:, lo:hi]), torch.from_numpy(t[:, lo:hi]), num_bins=256
        )
        jh = jax_acc(jh, s[:, lo:hi], t[:, lo:hi], num_bins=256, backend="xla")
    oneshot = _port(s, t, None, num_bins=256, bounds=(0.0, 1.0))
    np.testing.assert_array_equal(h.numpy(), oneshot)
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))


def test_accumulate_requires_bounds():
    with pytest.raises(ValueError, match="requires fixed bounds"):
        fused_auc_histogram_accumulate(torch.zeros((1, 2, 8)), torch.ones(4), torch.ones(4), num_bins=8, bounds=None)
    with pytest.raises(ValueError, match="hi > lo"):
        fused_auc_histogram(torch.ones(4), torch.ones(4), bounds=(1.0, 1.0))


@pytest.mark.parametrize("weights", ["none", "random"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_auc_and_auprc_from_hist_match_jax(weights, shape):
    s, t, w = _data(9, shape, weights=weights)
    h = _port(s, t, w, num_bins=BINS, bounds=(0.0, 1.0))
    np.testing.assert_allclose(
        _auc_from_hist(torch.from_numpy(h)).numpy(),
        np.asarray(jax_auc_from_hist(jnp.asarray(h))), atol=1e-6,
    )
    np.testing.assert_allclose(
        _auprc_from_hist(torch.from_numpy(h)).numpy(),
        np.asarray(jax_auprc_from_hist(jnp.asarray(h))), atol=1e-6,
    )


@pytest.mark.parametrize("bounds", [None, (0.0, 1.0)], ids=str)
def test_fused_auc_matches_jax(bounds):
    s, t, w = _data(10, (3, 5000), weights="random")
    got = fused_auc(torch.from_numpy(s), torch.from_numpy(t), torch.from_numpy(w), bounds=bounds)
    want = jax_fused_auc(s, t, w, backend="xla", bounds=bounds)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    scalar = fused_auc(torch.from_numpy(s[0]), torch.from_numpy(t[0]), device=CPU)
    assert scalar.ndim == 0


def test_degenerate_and_perfect_auc():
    assert float(fused_auc(torch.tensor([0.2, 0.8]), torch.tensor([1, 1]))) == 0.5
    assert float(fused_auc(torch.tensor([0.1, 0.5, 0.7, 0.8]), torch.tensor([0, 0, 1, 1]))) == 1.0
    assert float(fused_auc(torch.full((10,), 0.5), torch.arange(10) % 2)) == 0.5


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never computes on a CPU tensor: the CPU path is
    the plain version, chosen by the caller before the wrapper."""
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        _histogram_cuda(
            torch.zeros((1, 2, 8)), torch.zeros((1, 4)), torch.zeros((1, 4)), None, 8, (0.0, 1.0)
        )
