"""torcheval_tpu_torch's image path -- ``peak_signal_noise_ratio``,
``PeakSignalNoiseRatio``, ``FrechetInceptionDistance``, ``FIDInceptionV3``
and the InceptionV3 ``nn.Module`` with its weight carry-across -- against
the JAX package on the same numpy inputs.

Tolerances:

- InceptionV3: the port's forward against the Flax ``apply`` on the same
  weights (carried across by ``from_flax_variables``) at 75x75, and
  against the committed golden pooled features at 299x299, within rtol =
  atol = 1e-3 (the JAX package's own golden test's tolerance; Flax and
  torch round conv, batch norm and pooling differently). Where the
  features are small (Flax's default init), atol is 1e-3 of their largest
  magnitude.
- FID states within rtol 1e-5 (XLA and torch order the float32 matmul
  sums differently); the FID value within 1e-4 of ``tr S1 + tr S2``, the
  scale of the terms it is the difference of.
- PSNR within rtol 1e-6 (a log10 of float32 sums in other orders); states
  bitwise on integer-valued images.
- The resize within atol 2e-5 of ``jax.image.resize(..., antialias=False)``
  (the JAX package's own resize test's bound).
"""

from __future__ import annotations

import doctest
import importlib
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as JM
import torcheval_tpu.metrics.functional as JF
import torcheval_tpu_torch.metrics as TM
import torcheval_tpu_torch.metrics.functional as TF
from tests.metrics.image._torch_inception_mirror import synth_torchvision_state_dict
from torcheval_tpu.metrics.image.fid import _frechet_distance as _jax_frechet_distance
from torcheval_tpu.models import inception as jinception
from torcheval_tpu_torch.metrics.image.fid import (
    FIDInceptionV3,
    _frechet_distance,
    _resize_299,
)
from torcheval_tpu_torch.models import inception as tinception
from torcheval_tpu_torch.utils import load_numpy_state_dict, numpy_state_dict
from torcheval_tpu_torch.utils.test_utils import MetricClassTester

CPU = "cpu"
RTOL = 1e-6
FEATURE_RTOL = FEATURE_ATOL = 1e-3
STATE_RTOL = 1e-5
FID_TOL = 1e-4  # of tr S1 + tr S2
GOLDEN = "tests/metrics/image/golden_inception_activations.npz"


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _same(got, want):
    """Bitwise, with any NaN equal to any NaN (payloads carry nothing)."""
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, got.dtype,
                                                                  want.shape, want.dtype)
    nan = np.isnan(want) if want.dtype.kind == "f" else np.zeros(want.shape, bool)
    assert np.array_equal(np.isnan(got) if got.dtype.kind == "f" else nan, nan), (got, want)
    assert got[~nan].tobytes() == want[~nan].tobytes(), (got, want)


def _close(got, want, rtol=RTOL, atol=0.0):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, got.dtype,
                                                                  want.shape, want.dtype)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, equal_nan=True)


def _assert_states(tm, jm, rtol=None):
    assert set(tm._state_name_to_default) == set(jm._state_name_to_default)
    for name in jm._state_name_to_default:
        if rtol is None:
            _same(getattr(tm, name), getattr(jm, name))
        else:
            _close(getattr(tm, name), getattr(jm, name), rtol=rtol,
                   atol=rtol * float(np.abs(np.asarray(getattr(jm, name))).max(initial=0)))
    for name, kind in jm._state_name_to_merge_kind.items():
        assert tm._state_name_to_merge_kind[name].value == kind.value, name


# ------------------------------------------------------------ PSNR


def _images(seed, shape, exact):
    rng = np.random.default_rng(seed)
    if exact:
        target = rng.integers(0, 256, shape).astype(np.float32)
        return np.clip(target + rng.integers(-9, 10, shape), 0, 255).astype(np.float32), target
    target = rng.random(shape).astype(np.float32)
    return (target + 0.05 * rng.standard_normal(shape)).astype(np.float32), target


@pytest.mark.parametrize("data_range", [None, 1.0, 255.0])
@pytest.mark.parametrize("shape", [(1, 1, 1, 2), (2, 3, 8, 8), (4, 3, 17, 5), (3, 40)])
@pytest.mark.parametrize("exact", [True, False], ids=["int", "float"])
def test_psnr_matches_jax(exact, shape, data_range):
    x, y = _images(sum(shape), shape, exact)
    got = TF.peak_signal_noise_ratio(torch.from_numpy(x), torch.from_numpy(y), data_range)
    _close(got, JF.peak_signal_noise_ratio(x, y, data_range))


def test_psnr_of_identical_images_is_inf_like_jax():
    x, _ = _images(1, (2, 3, 4, 4), False)
    _same(TF.peak_signal_noise_ratio(x, x, device=CPU), JF.peak_signal_noise_ratio(x, x))


def test_psnr_of_empty_images_matches_jax():
    """A fixed range gives NaN (0 / 0) in both packages; the auto range
    has no max or min of an empty target and raises in both."""
    x = np.zeros((0, 3, 4, 4), np.float32)
    _same(TF.peak_signal_noise_ratio(x, x, 1.0, device=CPU), JF.peak_signal_noise_ratio(x, x, 1.0))
    _same(TM.PeakSignalNoiseRatio(1.0, device=CPU).update(x, x).compute(),
          JM.PeakSignalNoiseRatio(1.0).update(x, x).compute())
    with pytest.raises(ValueError):
        JF.peak_signal_noise_ratio(x, x)
    with pytest.raises(RuntimeError):
        TF.peak_signal_noise_ratio(x, x, device=CPU)
    with pytest.raises(RuntimeError):
        TM.PeakSignalNoiseRatio(device=CPU).update(x, x)


@pytest.mark.parametrize("kwargs", [
    dict(data_range=1), dict(data_range=-1.0), dict(data_range=0.0),
    dict(data_range=np.float32(1.0)),
])
def test_psnr_data_range_checks_match_jax(kwargs):
    x = np.ones((1, 3, 2, 2), np.float32)
    with pytest.raises(ValueError) as want:
        JF.peak_signal_noise_ratio(x, x, **kwargs)
    with pytest.raises(ValueError) as got:
        TF.peak_signal_noise_ratio(x, x, **kwargs, device=CPU)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as got:
        TM.PeakSignalNoiseRatio(**kwargs, device=CPU)
    assert str(got.value) == str(want.value)


def test_psnr_shape_check_matches_jax():
    a, b = np.ones((1, 3, 2, 2), np.float32), np.ones((1, 3, 2, 3), np.float32)
    with pytest.raises(ValueError) as want:
        JF.peak_signal_noise_ratio(a, b)
    with pytest.raises(ValueError) as got:
        TF.peak_signal_noise_ratio(a, b, device=CPU)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as got:
        TM.PeakSignalNoiseRatio(device=CPU).update(a, b)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("data_range", [None, 255.0])
@pytest.mark.parametrize("exact", [True, False], ids=["int", "float"])
def test_psnr_class_matches_jax(exact, data_range):
    tm = TM.PeakSignalNoiseRatio(data_range, device=CPU)
    jm = JM.PeakSignalNoiseRatio(data_range)
    for i in range(5):
        x, y = _images(40 + i, (2, 3, 6 + i, 5), exact)
        tm.update(torch.from_numpy(x), torch.from_numpy(y))
        jm.update(x, y)
        _assert_states(tm, jm, None if exact else RTOL)
        _close(tm.compute(), jm.compute())
    tm.reset()
    jm.reset()
    _assert_states(tm, jm)


def test_psnr_class_before_an_update_matches_jax():
    for data_range in (None, 2.0):
        _same(TM.PeakSignalNoiseRatio(data_range, device=CPU).compute(),
              JM.PeakSignalNoiseRatio(data_range).compute())


@pytest.mark.parametrize("data_range", [None, 255.0])
def test_psnr_merge_recomputes_the_range_like_jax(data_range):
    tms = [TM.PeakSignalNoiseRatio(data_range, device=CPU) for _ in range(3)]
    jms = [JM.PeakSignalNoiseRatio(data_range) for _ in range(3)]
    for i in range(6):
        x, y = _images(60 + i, (1, 3, 5, 5), True)
        x, y = x * (i + 1), y * (i + 1)  # each replica sees another range
        tms[i % 3].update(x, y)
        jms[i % 3].update(x, y)
    tms[0].merge_state(tms[1:])
    jms[0].merge_state(jms[1:])
    _assert_states(tms[0], jms[0])
    _close(tms[0].compute(), jms[0].compute())


@pytest.mark.parametrize("updated", [False, True], ids=["fresh", "updated"])
@pytest.mark.parametrize("data_range", [None, 255.0])
def test_psnr_state_dict_cross_loads_both_ways(data_range, updated):
    batches = [_images(80 + i, (2, 3, 4, 4), True) for i in range(4)]
    jm = JM.PeakSignalNoiseRatio(data_range)
    for x, y in batches[:2] if updated else []:
        jm.update(x, y)
    tm = TM.PeakSignalNoiseRatio(data_range, device=CPU)
    load_numpy_state_dict(tm, {k: np.asarray(v) for k, v in jm.state_dict().items()})
    _assert_states(tm, jm)
    back = JM.PeakSignalNoiseRatio(data_range)
    back.load_state_dict({k: jnp.asarray(v) for k, v in numpy_state_dict(tm).items()})
    _assert_states(tm, back)
    for x, y in batches[2:]:
        tm.update(x, y)
        back.update(x, y)
    _assert_states(tm, back)
    _close(tm.compute(), back.compute())


class TestPSNRClass(MetricClassTester):
    @pytest.mark.parametrize("data_range", [None, 1.0])
    def test_class_contract(self, data_range):
        batches = [_images(100 + i, (2, 3, 8, 8), False) for i in range(8)]
        whole = JM.PeakSignalNoiseRatio(data_range)
        for x, y in batches:
            whole.update(x, y)
        self.run_class_implementation_tests(
            metric=TM.PeakSignalNoiseRatio(data_range, device=CPU),
            state_names=set(whole._state_name_to_default),
            update_kwargs={"input": [b[0] for b in batches], "target": [b[1] for b in batches]},
            compute_result=np.asarray(whole.compute()),
            atol=1e-5,
            rtol=1e-6,
        )


# ------------------------------------------------------------ InceptionV3


@pytest.fixture(scope="module")
def flax_default():
    """The JAX package's default InceptionV3 variables (Flax's init) as
    numpy, and the Flax ``apply`` jitted once for both carried trees."""
    variables = jax.tree_util.tree_map(np.asarray, jinception.init_inception_params())
    return variables, jax.jit(jinception.InceptionV3().apply)


@pytest.fixture(scope="module")
def synth():
    """torchvision-format random weights (He-scaled convs, plausible batch
    statistics) and the same weights as a Flax tree through the JAX
    package's own torchvision loader."""
    sd = synth_torchvision_state_dict(0)
    variables = jax.tree_util.tree_map(np.asarray, jinception.load_torchvision_inception_params(sd))
    return sd, variables


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _port(state_dict):
    m = tinception.InceptionV3()
    m.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()}, strict=True)
    return m


def _forward(module, images_nchw):
    with torch.no_grad():
        return module(torch.from_numpy(images_nchw)).numpy()


def test_every_flax_leaf_lands_with_its_values(flax_default):
    variables, _ = flax_default
    sd = tinception.from_flax_variables(variables)
    leaves = {("params",) + p: v for p, v in _flat(variables["params"])}
    leaves.update({("batch_stats",) + p: v for p, v in _flat(variables["batch_stats"])})
    assert len(sd) == len(leaves) == 470
    for (collection, *path, leaf), value in leaves.items():
        name = ".".join(path) + "." + {"kernel": "weight", "scale": "weight", "bias": "bias",
                                       "mean": "running_mean", "var": "running_var"}[leaf]
        want = value.transpose(3, 2, 0, 1) if leaf == "kernel" else value
        _same(sd[name], want)
    assert set(sd) == set(tinception._parameter_shapes())


def test_carried_torchvision_weights_come_back_unchanged(synth):
    sd, variables = synth
    back = tinception.from_flax_variables(variables)
    assert set(back) == set(sd)
    for name, value in sd.items():
        _same(back[name], value)


def test_forward_matches_flax_apply_at_75(flax_default, synth):
    _, apply = flax_default
    images = np.random.default_rng(5).uniform(size=(2, 3, 75, 75)).astype(np.float32)
    nhwc = jnp.transpose(jnp.asarray(images), (0, 2, 3, 1))
    for variables in (flax_default[0], synth[1]):
        got = _forward(_port(tinception.from_flax_variables(variables)), images)
        want = np.asarray(apply(variables, nhwc))
        assert got.shape == (2, tinception.FEATURE_DIM)
        np.testing.assert_allclose(got, want, rtol=FEATURE_RTOL, atol=FEATURE_ATOL)
        # Flax's default init gives features near 1e-4: hold them to their scale too
        np.testing.assert_allclose(got, want, rtol=FEATURE_RTOL,
                                   atol=FEATURE_ATOL * float(np.abs(want).max()))


def test_pooled_features_match_the_committed_golden(synth):
    golden = np.load(GOLDEN)
    images = np.random.default_rng(1).uniform(size=(2, 3, 299, 299)).astype(np.float32)
    got = _forward(_port(synth[0]), images)
    np.testing.assert_allclose(got, golden["pool"], rtol=FEATURE_RTOL, atol=FEATURE_ATOL)


def test_transform_input_is_torchvisions_affine():
    x = torch.rand(1, 3, 75, 75, generator=torch.Generator().manual_seed(2))
    sd = tinception.init_inception_params(torch.Generator().manual_seed(3))
    with_t, without_t = tinception.InceptionV3(), tinception.InceptionV3(transform_input=False)
    with_t.load_state_dict(sd)
    without_t.load_state_dict(sd)
    manual = torch.cat([x[:, 0:1] * (0.229 / 0.5) + (0.485 - 0.5) / 0.5,
                        x[:, 1:2] * (0.224 / 0.5) + (0.456 - 0.5) / 0.5,
                        x[:, 2:3] * (0.225 / 0.5) + (0.406 - 0.5) / 0.5], 1)
    with torch.no_grad():
        torch.testing.assert_close(with_t(x), without_t(manual), rtol=1e-5, atol=1e-5)


def test_random_init_is_seeded_and_keeps_activations_alive():
    a = tinception.init_inception_params(torch.Generator().manual_seed(7))
    b = tinception.init_inception_params(torch.Generator().manual_seed(7))
    c = tinception.init_inception_params(torch.Generator().manual_seed(8))
    assert set(a) == set(tinception._parameter_shapes())
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["Conv2d_1a_3x3.conv.weight"], c["Conv2d_1a_3x3.conv.weight"])
    images = np.random.default_rng(3).uniform(size=(2, 3, 75, 75)).astype(np.float32)
    feats = _forward(_port(a), images)
    assert np.isfinite(feats).all() and 0.05 < feats.std() < 20.0


def test_module_starts_in_eval_mode():
    assert not tinception.InceptionV3().training


def test_loader_rejects_an_unknown_name(synth):
    sd = dict(synth[0])
    sd["Mixed_5b.branch9x9.conv.weight"] = np.zeros((1,), np.float32)
    with pytest.raises(KeyError, match="branch9x9"):
        tinception.load_torchvision_inception_params(sd)


def test_loader_rejects_a_shape_mismatch(synth):
    sd = dict(synth[0])
    sd["Mixed_6a.branch3x3.conv.weight"] = sd["Mixed_6a.branch3x3.conv.weight"][:, :5]
    with pytest.raises(ValueError, match="shape mismatch at Mixed_6a.branch3x3.conv.weight"):
        tinception.load_torchvision_inception_params(sd)


def test_loader_rejects_a_missing_parameter(synth):
    sd = dict(synth[0])
    del sd["Mixed_7c.branch_pool.bn.running_var"]
    with pytest.raises(ValueError, match="not covered"):
        tinception.load_torchvision_inception_params(sd)


def test_loader_skips_the_head_and_batch_counts(synth):
    sd = dict(synth[0])
    sd.update({"fc.weight": np.zeros((1000, 2048), np.float32), "fc.bias": np.zeros(1000),
               "AuxLogits.fc.weight": np.zeros((1000, 768), np.float32),
               "Conv2d_1a_3x3.bn.num_batches_tracked": np.int64(0)})
    assert set(tinception.load_torchvision_inception_params(sd)) == set(synth[0])


def test_from_flax_variables_rejects_an_unknown_leaf(flax_default):
    variables = {"params": {"Conv2d_1a_3x3": {"conv": {"kernal": np.zeros((3, 3, 3, 32))}}},
                 "batch_stats": {}}
    with pytest.raises(KeyError, match="kernal"):
        tinception.from_flax_variables(variables)


def test_pretrained_weights_need_torchvision(monkeypatch):
    monkeypatch.setitem(sys.modules, "torchvision", None)
    with pytest.raises(ImportError):
        tinception.load_torchvision_inception_params()
    with pytest.raises(ImportError, match="torchvision"):
        FIDInceptionV3()
    with pytest.raises(ImportError, match="torchvision"):
        TM.FrechetInceptionDistance(device=CPU)


# ------------------------------------------------------------ resize


@pytest.mark.parametrize("hw", [(32, 32), (64, 64), (512, 640)])
def test_resize_matches_jax_image_resize(hw):
    images = np.random.default_rng(sum(hw)).uniform(size=(2, 3) + hw).astype(np.float32)
    got = _resize_299(torch.from_numpy(images)).numpy()
    want = jax.image.resize(jnp.transpose(jnp.asarray(images), (0, 2, 3, 1)), (2, 299, 299, 3),
                            method="bilinear", antialias=False)
    np.testing.assert_allclose(got, np.transpose(np.asarray(want), (0, 3, 1, 2)), atol=2e-5)


# ------------------------------------------------------------ FID


def _jax_spread(images):
    """The JAX docstring's 4-d extractor."""
    pooled = images.mean(axis=(2, 3))
    spread = images.var(axis=(1, 2, 3))[:, None]
    return jnp.concatenate([pooled, spread], axis=1)


def _torch_spread(images):
    pooled = images.mean(dim=(2, 3))
    spread = images.var(dim=(1, 2, 3), correction=0)[:, None]
    return torch.cat([pooled, spread], dim=1)


_PROJ = (np.random.default_rng(21).standard_normal((3 * 6 * 6, 64)) / 6).astype(np.float32)


def _jax_proj(images):
    return images.reshape(images.shape[0], -1) @ jnp.asarray(_PROJ)


class _TorchProj(torch.nn.Module):
    """A 64-d linear extractor as an ``nn.Module`` (moved and put in eval
    mode by the metric)."""

    def __init__(self):
        super().__init__()
        self.register_buffer("proj", torch.from_numpy(_PROJ))

    def forward(self, images):
        return images.reshape(images.shape[0], -1) @ self.proj


EXTRACTORS = {"spread4": (_torch_spread, _jax_spread, 4), "proj64": (_TorchProj, _jax_proj, 64)}


def _make(P, name, **k):
    torch_model, jax_model, dim = EXTRACTORS[name]
    if P is TM:
        model = torch_model() if isinstance(torch_model, type) else torch_model
        return TM.FrechetInceptionDistance(model=model, feature_dim=dim, **k)
    return JM.FrechetInceptionDistance(model=jax_model, feature_dim=dim)


def _fid_batches(seed, n=8, size=6, batch=40):
    """Real images uniform in [0, 1]; fake ones a darker, noisier set.
    Each distribution gets more images than the widest extractor has
    features: a rank-deficient covariance has eigenvalues at rounding
    level whose square roots dominate the error of any float32 FID."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        imgs = rng.uniform(size=(batch, 3, size, size)).astype(np.float32)
        if i % 2:
            imgs = np.clip(0.8 * imgs + 0.1 * rng.standard_normal(imgs.shape), 0, 1).astype(
                np.float32)
        out.append((imgs, i % 2 == 0))
    return out


def _trace_scale(m):
    """tr S1 + tr S2 of a metric's states, in float64."""
    total = 0.0
    for s, c, n in (("real_sum", "real_cov_sum", "num_real_images"),
                    ("fake_sum", "fake_cov_sum", "num_fake_images")):
        s, c, n = (np.asarray(_np(getattr(m, a)), np.float64) for a in (s, c, n))
        total += np.trace((c - n * np.outer(s / n, s / n)) / (n - 1))
    return total


@pytest.mark.parametrize("name", sorted(EXTRACTORS))
def test_fid_matches_jax(name):
    tm, jm = _make(TM, name, device=CPU), _make(JM, name)
    for imgs, is_real in _fid_batches(3):
        tm.update(torch.from_numpy(imgs), is_real=is_real)
        jm.update(imgs, is_real=is_real)
    _assert_states(tm, jm, STATE_RTOL)
    got, want = float(tm.compute()), float(jm.compute())
    assert abs(got - want) <= FID_TOL * _trace_scale(jm), (got, want)
    assert tm.compute().dtype == torch.float32 and tm.compute().shape == ()


@pytest.mark.parametrize("dim", [4, 64, 300])
def test_frechet_distance_matches_jax_on_the_same_states(dim):
    rng = np.random.default_rng(dim)
    states = []
    for n, shift in ((70, 0.0), (50, 0.4)):
        a = (rng.standard_normal((n, dim)) @ rng.standard_normal((dim, dim)) / np.sqrt(dim)
             + shift).astype(np.float32)
        states += [a.sum(0), a.T @ a, np.int32(n)]
    got = _frechet_distance(*(torch.as_tensor(np.asarray(s)) for s in states))
    want = _jax_frechet_distance(*(jnp.asarray(s) for s in states))
    scale = 0.0
    for s, c, n in (states[:3], states[3:]):
        s, c, n = np.float64(s), np.float64(c), float(n)
        scale += np.trace((c - n * np.outer(s / n, s / n)) / (n - 1))
    assert abs(float(got) - float(want)) <= FID_TOL * scale, (float(got), float(want))


def test_fid_of_one_stream_twice_is_near_zero():
    tm = _make(TM, "proj64", device=CPU)
    for imgs, _ in _fid_batches(4):
        tm.update(imgs, is_real=True).update(imgs, is_real=False)
    assert abs(float(tm.compute())) <= FID_TOL * _trace_scale(tm)


@pytest.mark.parametrize("feed", [[], [True], [False]], ids=["none", "real", "fake"])
def test_fid_warns_and_returns_zero_like_jax(feed):
    imgs = _fid_batches(5)[0][0]
    for P, k in ((TM, {"device": CPU}), (JM, {})):
        m = _make(P, "spread4", **k)
        for is_real in feed:
            m.update(imgs, is_real=is_real)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            result = m.compute()
        assert float(result) == 0.0 and tuple(result.shape) == ()
        assert any(issubclass(x.category, RuntimeWarning)
                   and "requires at least 1" in str(x.message) for x in w)


@pytest.mark.parametrize("images, is_real", [
    (np.zeros((3, 6, 6), np.float32), True),
    (np.zeros((2, 1, 6, 6), np.float32), True),
    (np.zeros((2, 3, 6, 6), np.float32), 1),
    (np.zeros((2, 3, 6, 6), np.float32), "yes"),
])
def test_fid_input_checks_match_jax(images, is_real):
    with pytest.raises(ValueError) as want:
        _make(JM, "spread4").update(images, is_real=is_real)
    with pytest.raises(ValueError) as got:
        _make(TM, "spread4", device=CPU).update(images, is_real=is_real)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kwargs, match", [
    (dict(model=_torch_spread, feature_dim=0), "positive integer"),
    (dict(model=_torch_spread, feature_dim=-3), "positive integer"),
    (dict(feature_dim=64), "2048"),
])
def test_fid_parameter_checks_match_jax(kwargs, match):
    jkw = dict(kwargs, model=_jax_spread) if "model" in kwargs else kwargs
    with pytest.raises(RuntimeError, match=match):
        JM.FrechetInceptionDistance(**jkw)
    with pytest.raises(RuntimeError, match=match):
        TM.FrechetInceptionDistance(**kwargs, device=CPU)


@pytest.fixture(scope="module")
def fid_inception():
    return FIDInceptionV3(tinception.init_inception_params(torch.Generator().manual_seed(11)))


def test_default_architecture_needs_float32_images(fid_inception):
    m = TM.FrechetInceptionDistance(model=fid_inception, device=CPU)
    with pytest.raises(ValueError, match="`float32`, but got torch.uint8"):
        m.update(torch.zeros((1, 3, 8, 8), dtype=torch.uint8), is_real=True)
    with pytest.raises(ValueError, match="`float32`, but got torch.float64"):
        m.update(torch.zeros((1, 3, 8, 8), dtype=torch.float64), is_real=True)


def test_default_architecture_updates_and_stays_in_eval_mode(fid_inception):
    m = TM.FrechetInceptionDistance(model=fid_inception, device=CPU)
    assert not m.model.training and not m.model.model.training
    gen = torch.Generator().manual_seed(12)
    m.update(torch.rand(2, 3, 32, 32, generator=gen), is_real=True)
    m.update(torch.rand(2, 3, 32, 32, generator=gen) * 0.5, is_real=False)
    assert int(m.num_real_images) == int(m.num_fake_images) == 2
    assert m.real_cov_sum.shape == (2048, 2048) and m.real_cov_sum.requires_grad is False
    fid = m.compute()
    assert torch.isfinite(fid) and float(fid) > 0
    fid_inception.train()  # a caller flips it back to training mode
    m.to(CPU)
    assert not m.model.training and not any(x.training for x in m.model.modules())


def test_a_user_module_is_moved_and_put_in_eval_mode():
    model = _TorchProj().train()
    m = TM.FrechetInceptionDistance(model=model, feature_dim=64, device=CPU)
    assert m.model is model and not model.training
    assert not any(p.requires_grad for p in model.parameters())
    model.train()
    assert not m.to(CPU).model.training


@pytest.mark.parametrize("name", sorted(EXTRACTORS))
def test_fid_merge_state_matches_jax(name):
    tms, jms = [_make(TM, name, device=CPU) for _ in range(3)], [_make(JM, name) for _ in range(3)]
    for i, (imgs, is_real) in enumerate(_fid_batches(6)):
        tms[i % 3].update(imgs, is_real=is_real)
        jms[i % 3].update(imgs, is_real=is_real)
    tms[0].merge_state(tms[1:])
    jms[0].merge_state(jms[1:])
    _assert_states(tms[0], jms[0], STATE_RTOL)
    assert abs(float(tms[0].compute()) - float(jms[0].compute())) <= FID_TOL * _trace_scale(jms[0])


@pytest.mark.parametrize("updated", [False, True], ids=["fresh", "updated"])
@pytest.mark.parametrize("name", sorted(EXTRACTORS))
def test_fid_state_dict_cross_loads_both_ways(name, updated):
    batches = _fid_batches(7)
    jm = _make(JM, name)
    for imgs, is_real in batches[:4] if updated else []:
        jm.update(imgs, is_real=is_real)
    tm = _make(TM, name, device=CPU)
    load_numpy_state_dict(tm, {k: np.asarray(v) for k, v in jm.state_dict().items()})
    _assert_states(tm, jm)
    back = _make(JM, name)
    back.load_state_dict({k: jnp.asarray(v) for k, v in numpy_state_dict(tm).items()})
    _assert_states(tm, back)
    for imgs, is_real in batches[4:]:
        tm.update(imgs, is_real=is_real)
        back.update(imgs, is_real=is_real)
    _assert_states(tm, back, STATE_RTOL)
    assert abs(float(tm.compute()) - float(back.compute())) <= FID_TOL * _trace_scale(back)


class TestFIDClass(MetricClassTester):
    @pytest.mark.parametrize("name", sorted(EXTRACTORS))
    def test_class_contract(self, name):
        batches = _fid_batches(8)
        whole = _make(JM, name)
        for imgs, is_real in batches:
            whole.update(imgs, is_real=is_real)
        tol = FID_TOL * _trace_scale(whole)
        self.run_class_implementation_tests(
            metric=_make(TM, name, device=CPU),
            state_names=set(whole._state_name_to_default),
            update_kwargs={"images": [b[0] for b in batches], "is_real": [b[1] for b in batches]},
            compute_result=np.asarray(whole.compute()),
            atol=tol,
            rtol=0.0,
        )


# ------------------------------------------------------------ surface


_DOC_MODULES = [
    "torcheval_tpu_torch.metrics.functional.image.psnr",
    "torcheval_tpu_torch.metrics.image.psnr",
    "torcheval_tpu_torch.metrics.image.fid",
]


@pytest.mark.parametrize("module", _DOC_MODULES,
                         ids=lambda m: m.rsplit(".", 2)[-2] + "." + m.rsplit(".", 1)[-1])
def test_docstring_examples_run(module):
    result = doctest.testmod(importlib.import_module(module),
                             optionflags=doctest.NORMALIZE_WHITESPACE)
    assert result.attempted > 0 and result.failed == 0


@pytest.mark.parametrize("make", [
    lambda **k: TM.PeakSignalNoiseRatio(**k),
    lambda **k: TM.FrechetInceptionDistance(model=_torch_spread, feature_dim=4, **k),
])
def test_classes_default_to_cuda(make):
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_the_port_exports_the_image_path():
    for name in ("FrechetInceptionDistance", "PeakSignalNoiseRatio", "functional"):
        assert name in TM.__all__ and name in JM.__all__
    assert "peak_signal_noise_ratio" in TF.__all__ and "peak_signal_noise_ratio" in JF.__all__
    from torcheval_tpu_torch import models

    assert models.InceptionV3 is tinception.InceptionV3 and models.FEATURE_DIM == 2048
    assert TM.functional is TF
