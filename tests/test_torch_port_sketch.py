"""The port's input sketches (``torcheval_tpu_torch/obs/sketch.py``) against
the JAX package's (``torcheval_tpu/obs/sketch.py``), fed the same seeded
numpy inputs on the CPU.

Held bitwise: the counter, histogram and register lanes of a batch fold
(the JAX fold as its own tests run it, jitted, native on the CPU), the bit
helpers (``_fmix32``, ``_clz32``, ``_exponent_of``) at the special float32
patterns, ``chan_merge`` (under this suite's
``--xla_backend_optimization_level=0``; at XLA's default level the CPU
backend fuses its mean and M2 updates into multiply-adds, an ulp away),
the register estimate, and sketches merged in a ``ThreadWorld`` against one
stream. The batch moments are float sums, sequential in the JAX package
and not in torch: held to ``MOMENT_RTOL``.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torcheval_tpu.obs import sketch as JS
from torcheval_tpu.utils.test_utils import ThreadWorld as JThreadWorld
from torcheval_tpu.metrics import toolkit as jtoolkit
from torcheval_tpu_torch import config
from torcheval_tpu_torch.metrics import toolkit as ttoolkit
from torcheval_tpu_torch.obs import sketch as TS
from torcheval_tpu_torch.utils import load_numpy_state_dict, numpy_state_dict
from torcheval_tpu_torch.utils.test_utils import MetricClassTester, ThreadWorld

CPU = "cpu"
# batch moments: float32 sums in another order (sequential in the JAX
# package, pairwise in torch), relative to each moment
MOMENT_RTOL = 1e-5
LANES = ("hist", "counts", "moments", "registers")
SPECIAL = np.array(
    [np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-40, -1e-45, 2.0**-126, 2.0**-3, -(2.0**2),
     3.4028235e38, -3.4028235e38, 2.0**30, 1.0, -1.0, 2.0**-24],
    np.float32,
)


def _configs(mode):
    if mode == "fixed":
        return JS.default_config(16, (-4.0, 4.0)), TS.default_config(16, (-4.0, 4.0))
    return JS.default_config(), TS.default_config()


def _jax_fold(cfg, x, w):
    states = (
        jnp.zeros((cfg.num_bins,), jnp.float32),
        jnp.zeros((8,), jnp.int32),
        JS.moment_default(),
        jnp.zeros((cfg.registers,), jnp.int32),
    )
    out = jax.jit(lambda s, a, b: JS._fold_fns(cfg)(s, a, b))(states, jnp.asarray(x), jnp.asarray(w))
    return [np.asarray(o) for o in out]


def _torch_fold(cfg, x, w):
    states = (
        torch.zeros(cfg.num_bins),
        torch.zeros(8, dtype=torch.int32),
        TS.moment_default(),
        torch.zeros(cfg.registers, dtype=torch.int32),
    )
    return [o.numpy() for o in TS._fold(cfg, states, torch.from_numpy(x), torch.from_numpy(w))]


def _batch(seed, n=512, special=True):
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=n).astype(np.float32)
    if special:
        vals[: len(SPECIAL)] = SPECIAL
    w = (rng.integers(0, 4, n) / 2).astype(np.float32)
    return vals, w


def _assert_moments_close(ours, theirs):
    ours, theirs = np.asarray(ours, np.float64), np.asarray(theirs, np.float64)
    assert ours[0] == theirs[0] and ours[3] == theirs[3] and ours[4] == theirs[4]
    np.testing.assert_allclose(ours[1:3], theirs[1:3], rtol=MOMENT_RTOL, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 7, 41])
@pytest.mark.parametrize("mode", ["fixed", "log2"])
def test_fold_lanes_bitwise_to_jax(mode, seed):
    """Counter, histogram and register lanes of one fold, across NaN, ±Inf,
    ±0, subnormals, the largest finite values and fractional weights."""
    jcfg, tcfg = _configs(mode)
    x, w = _batch(seed)
    want, got = _jax_fold(jcfg, x, w), _torch_fold(tcfg, x, w)
    for i in (0, 1, 3):
        assert got[i].dtype == want[i].dtype and got[i].tobytes() == want[i].tobytes(), LANES[i]


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("mode", ["fixed", "log2"])
def test_fold_moments_within_tolerance_of_jax(mode, seed):
    jcfg, tcfg = _configs(mode)
    x, w = _batch(seed, special=False)
    x[:6] = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-40]
    _assert_moments_close(_torch_fold(tcfg, x, w)[2], _jax_fold(jcfg, x, w)[2])


def _special_patterns():
    rng = np.random.default_rng(11)
    fixed = np.array(
        [0x00000000, 0x80000000, 0x00000001, 0x007FFFFF, 0x00400000, 0x80000001,
         0x7F800000, 0xFF800000, 0x7FC00000, 0x7FC00001, 0x7F800001, 0xFFFFFFFF,
         0x7F7FFFFF, 0xFF7FFFFF, 0x00800000, 0x3F800000, 0x80800000, 0x4B000000],
        np.uint32,
    )
    return np.concatenate([fixed, rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)])


def test_fmix32_and_clz32_bitwise_to_jax():
    bits = _special_patterns()
    ours = TS._fmix32(torch.from_numpy(bits.astype(np.int64)))
    theirs = np.asarray(JS._fmix32(jnp.asarray(bits)))
    assert np.array_equal(ours.numpy().astype(np.uint32), theirs)
    ours = TS._clz32(torch.from_numpy(bits.astype(np.int64)))
    theirs = np.asarray(JS._clz32(jnp.asarray(bits)))
    assert np.array_equal(ours.numpy(), theirs.astype(np.int64))


def test_exponent_of_bitwise_to_jax_on_every_float32_class():
    """Normals, subnormals (bit lengths 1-23), ±0, ±Inf and NaN payloads:
    the exponent lanes the log2 histogram bins by."""
    x = _special_patterns().view(np.float32)
    ours = TS._exponent_of(torch.from_numpy(x.copy()))
    theirs = np.asarray(JS._exponent_of(jnp.asarray(x)))
    assert np.array_equal(ours.numpy(), theirs.astype(np.int64))


def test_chan_merge_bitwise_to_jax():
    rng = np.random.default_rng(12)
    for _ in range(300):
        a = np.array([rng.integers(0, 1000), rng.normal(), rng.random() * 100,
                      rng.normal(), rng.normal()], np.float32)
        b = np.array([rng.integers(0, 1000), rng.normal(), rng.random() * 100,
                      rng.normal(), rng.normal()], np.float32)
        ours = TS.chan_merge(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        assert ours.tobytes() == np.asarray(JS.chan_merge(a, b)).tobytes()


def test_chan_merge_empty_identity_is_exact():
    a = torch.tensor([5.0, 0.3, 2.0, -1.0, 3.0])
    empty = TS.moment_default()
    assert TS.chan_merge(a, empty).numpy().tobytes() == a.numpy().tobytes()
    assert TS.chan_merge(empty, a).numpy().tobytes() == a.numpy().tobytes()


@pytest.mark.parametrize("n_distinct", [10, 100, 1000])
def test_distinct_registers_and_estimate_match_jax(n_distinct):
    vals = np.tile(np.arange(n_distinct, dtype=np.float32), 3)
    tm = TS.InputSketch(device=CPU).update(torch.from_numpy(vals))
    jm = JS.InputSketch().update(jnp.asarray(vals))
    assert tm.registers.numpy().tobytes() == np.asarray(jm.registers).tobytes()
    est = tm.compute().distinct
    assert est == jm.compute().distinct == JS.hll_estimate(np.asarray(jm.registers))
    assert TS.hll_estimate(tm.registers.numpy()) == est
    assert abs(est - n_distinct) / n_distinct < 0.35


def _summaries_close(ours, theirs):
    for field in TS.SketchSummary._fields:
        a, b = getattr(ours, field), getattr(theirs, field)
        if field == "hist":
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
        elif isinstance(b, int):
            assert a == b, field
        else:
            assert math.isclose(a, b, rel_tol=MOMENT_RTOL, abs_tol=1e-6), (field, a, b)


@pytest.mark.parametrize("kwargs", [
    dict(bounds=(0.0, 1.0), num_bins=4),
    dict(bounds=(-4.0, 4.0), num_bins=16),
    dict(),
    dict(log2_bounds=(-8, 8), registers=16),
], ids=["unit", "fixed16", "log2", "log2-narrow"])
def test_summary_matches_jax(kwargs):
    rng = np.random.default_rng(13)
    tm, jm = TS.InputSketch(device=CPU, **kwargs), JS.InputSketch(**kwargs)
    for i in range(3):
        x = rng.normal(size=(20, 3)).astype(np.float32) * (i + 1)
        x.reshape(-1)[:5] = [np.nan, np.inf, 0.0, -0.0, 2.0**-140]
        tm.update(torch.from_numpy(x))
        jm.update(jnp.asarray(x))
    _summaries_close(tm.compute(), jm.compute())
    np.testing.assert_array_equal(tm.edges(), jm.edges())
    for q in (0.0, 0.25, 0.5, 0.99, 1.0):
        assert tm.quantile(q) == jm.quantile(q)


def test_log2_mode_bins_magnitudes_and_skips_zeros():
    sk = TS.InputSketch(device=CPU)
    sk.update(torch.tensor([0.0, -0.0, 1.0, -1.0, 3.0, 0.25]))
    s = sk.compute()
    assert s.zero == 2 and s.negative == 1 and s.total == 6
    hist = s.hist
    assert hist[24] == 2 and hist[25] == 1 and hist[22] == 1 and hist.sum() == 4


def test_quantile_is_conservative_and_empty_is_none():
    sk = TS.InputSketch(bounds=(0.0, 1.0), num_bins=4, device=CPU)
    assert sk.quantile(0.5) is None
    sk.update(torch.tensor([0.1, 0.2, 0.6, 0.9]))
    assert sk.quantile(0.5) == 0.25 and sk.quantile(0.75) == 0.75 and sk.quantile(1.0) == 1.0
    with pytest.raises(ValueError):
        sk.quantile(1.5)


def test_weighted_update_drops_zero_weight_elements_like_jax():
    x = np.array([0.1, 0.2, 5.0, np.nan], np.float32)
    w = np.array([1.0, 0.5, 0.0, 0.0], np.float32)
    tm = TS.InputSketch(bounds=(0.0, 1.0), num_bins=4, device=CPU)
    tm.update(torch.from_numpy(x), torch.from_numpy(w))
    jm = JS.InputSketch(bounds=(0.0, 1.0), num_bins=4).update(jnp.asarray(x), jnp.asarray(w))
    s = tm.compute()
    assert s.total == 2 and s.nan == 0 and s.above == 0
    _summaries_close(s, jm.compute())
    with pytest.raises(ValueError):
        tm.update(torch.from_numpy(x), torch.ones(3))


@pytest.mark.parametrize("kwargs", [
    dict(registers=15), dict(registers=8), dict(bounds=(1.0, 1.0)), dict(bounds=(0.0, 1.0), num_bins=0),
    dict(log2_bounds=(3, 3)), dict(num_bins=5),
])
def test_param_validation_raises_like_jax(kwargs):
    with pytest.raises(ValueError):
        JS.InputSketch(**kwargs)
    with pytest.raises(ValueError):
        TS.InputSketch(device=CPU, **kwargs)


def _to_jax(sd):
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in sd.items()}


def test_state_dict_cross_loads_both_ways_and_reset():
    x = np.random.default_rng(14).normal(size=64).astype(np.float32)
    jm = JS.InputSketch(bounds=(-2.0, 2.0), num_bins=8).update(jnp.asarray(x))
    tm = TS.InputSketch(bounds=(-2.0, 2.0), num_bins=8, device=CPU)
    load_numpy_state_dict(tm, {k: np.asarray(v) for k, v in jm.state_dict().items()})
    for name in LANES:
        assert getattr(tm, name).numpy().tobytes() == np.asarray(getattr(jm, name)).tobytes()
    back = JS.InputSketch(bounds=(-2.0, 2.0), num_bins=8)
    back.load_state_dict(_to_jax(numpy_state_dict(tm)))
    for name in LANES:
        assert np.asarray(getattr(back, name)).tobytes() == getattr(tm, name).numpy().tobytes()
    tm.reset()
    s = tm.compute()
    assert s.total == 0 and s.min == math.inf and s.max == -math.inf


def _rank_batches(n=4, size=64, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=size).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("mode", ["fixed", "log2"])
def test_threadworld4_sync_bitwise_to_single_stream_and_jax(mode):
    """Each rank folds one batch; the rank-ordered sync replays the one
    stream bitwise (exact empty identities), and its lanes equal the JAX
    package's synced sketch."""
    kw = dict(bounds=(-4.0, 4.0), num_bins=16) if mode == "fixed" else {}
    batches = _rank_batches()
    single = TS.InputSketch(device=CPU, **kw)
    for b in batches:
        single.update(torch.from_numpy(b))

    def body(g):
        sk = TS.InputSketch(device=CPU, **kw).update(torch.from_numpy(batches[g.rank]))
        return ttoolkit.get_synced_metric(sk, g)

    def jbody(g):
        sk = JS.InputSketch(**kw).update(jnp.asarray(batches[g.rank]))
        return jtoolkit.get_synced_metric(sk, g)

    jsynced = JThreadWorld(4).run(jbody)[0]
    for synced in ThreadWorld(4).run(body):
        for name in LANES:
            assert getattr(synced, name).numpy().tobytes() == getattr(single, name).numpy().tobytes()
        for name in ("hist", "counts", "registers"):
            assert getattr(synced, name).numpy().tobytes() == np.asarray(getattr(jsynced, name)).tobytes()
        _assert_moments_close(synced.moments.numpy(), np.asarray(jsynced.moments))


def test_bucketed_stream_lanes_bitwise_to_eager():
    rng = np.random.default_rng(15)
    eager, bucketed = TS.InputSketch(device=CPU), TS.InputSketch(device=CPU)
    for n in (64, 37, 5, 64, 17):
        x = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
        eager.update(x)
        with config.shape_bucketing():
            bucketed.update(x)
    for name in ("hist", "counts", "registers"):
        assert torch.equal(getattr(eager, name), getattr(bucketed, name))
    _assert_moments_close(bucketed.moments.numpy(), eager.moments.numpy())


N, WORLD = 8, 4


class TestInputSketchClass(MetricClassTester):
    @pytest.mark.parametrize("kwargs", [dict(bounds=(-3.0, 3.0), num_bins=12), dict()],
                             ids=["fixed", "log2"])
    def test_class_contract(self, kwargs):
        rng = np.random.default_rng(16)
        values = [rng.normal(size=(10 + i, 2)).astype(np.float32) for i in range(N)]
        whole = JS.InputSketch(**kwargs)
        for v in values:
            whole.update(jnp.asarray(v))
        per = N // WORLD
        ranks = []
        for r in range(WORLD):
            m = JS.InputSketch(**kwargs)
            for v in values[r * per:(r + 1) * per]:
                m.update(jnp.asarray(v))
            ranks.append(m)
        ranks[0].merge_state(ranks[1:])
        self.run_class_implementation_tests(
            metric=TS.InputSketch(device=CPU, **kwargs),
            state_names=set(LANES),
            update_kwargs={"values": values},
            compute_result=tuple(whole.compute()),
            merge_and_compute_result=tuple(ranks[0].compute()),
            num_total_updates=N,
            num_processes=WORLD,
            atol=1e-5,
            rtol=MOMENT_RTOL,
        )
