"""Sharded metric state in the port (``metrics/shardspec.py`` and the
metric core's shard hooks) against the JAX package's eager sharding,
twins of ``tests/metrics/test_shardspec.py`` and
``tests/metrics/test_value_routing.py``.

Every sharded class is fed the same seeded numpy stream in both packages,
at the same world, on the CPU: each rank's shard, outbox, cursors and
boundary buffer are held bitwise to the JAX package's, and so are the
synced ``compute()`` (``ThreadWorld`` in both packages), the reassembling
merge, ``adopt_synced``, the elastic 4->2 resume and the ``state_dict``
cross-loads both ways. The JAX mesh path (``from_mesh`` over a
``NamedSharding``) has no torch counterpart; the port's ``from_mesh`` is
tested on a gloo ``DeviceMesh`` in ``test_torch_port_sharded.py``.
"""

from __future__ import annotations

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as JM
from torcheval_tpu.metrics import toolkit as jtoolkit
from torcheval_tpu.utils.test_utils import ThreadWorld as JThreadWorld
import torcheval_tpu_torch.metrics as TM
from torcheval_tpu_torch import config
from torcheval_tpu_torch.elastic import ElasticSession
from torcheval_tpu_torch.metrics import shardspec, toolkit
from torcheval_tpu_torch.obs import memory_report
from torcheval_tpu_torch.utils import CompileCounter, load_numpy_state_dict, numpy_state_dict
from torcheval_tpu_torch.utils.checkpoint import validate_state_dict
from torcheval_tpu_torch.utils.test_utils import ThreadWorld

CPU = "cpu"
RNG = np.random.default_rng(90)
C, WORLD, T = 16, 4, 16
CM_BATCHES = [(RNG.integers(0, C, 64), RNG.integers(0, C, 64)) for _ in range(8)]
AU_BATCHES = [(RNG.uniform(size=64).astype(np.float32), RNG.integers(0, 2, 64).astype(np.int32))
              for _ in range(8)]
WC_ROWS = [(RNG.uniform(size=48).astype(np.float32), RNG.integers(0, 2, 48).astype(np.float32),
            RNG.uniform(0.5, 2.0, 48).astype(np.float32), RNG.integers(-1, T + 1, 48))
           for _ in range(8)]
RAGGED_CM = [(RNG.integers(0, C, n), RNG.integers(0, C, n)) for n in (64, 37, 12, 5, 21, 33, 7, 50)]


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _assert_same_states(tm, jm, rtol=None):
    """Every state of the JAX metric, bitwise in the port's (or, where the
    two packages' float reductions sum in another order, within ``rtol``)."""
    jsd = jm.state_dict()
    assert sorted(tm.state_dict()) == sorted(jsd)
    for name, value in jsd.items():
        ours, theirs = _np(getattr(tm, name)), np.asarray(value)
        assert ours.dtype == theirs.dtype and ours.shape == theirs.shape, name
        if rtol is None or not np.issubdtype(ours.dtype, np.floating):
            assert ours.tobytes() == theirs.tobytes(), name
        else:
            np.testing.assert_allclose(ours, theirs, rtol=rtol, err_msg=name)


# each case: (port constructor, JAX constructor, feed(metric, batch, to), batches)
def _feed_pair(m, b, to):
    m.update(to(b[0]), to(b[1]))


def _feed_rows(m, b, to):
    m.update(to(b[0]), to(b[1]), to(b[2]), task_ids=to(b[3]))


CASES = {
    "confusion_matrix": (
        lambda ctx=None, **k: TM.MulticlassConfusionMatrix(C, shard=ctx, device=CPU, **k),
        lambda ctx=None: JM.MulticlassConfusionMatrix(C, shard=ctx),
        _feed_pair, CM_BATCHES,
    ),
    "histogram_auroc": (
        lambda ctx=None, **k: TM.HistogramBinnedAUROC(threshold=32, shard=ctx, device=CPU, **k),
        lambda ctx=None: JM.HistogramBinnedAUROC(threshold=32, shard=ctx),
        _feed_pair, AU_BATCHES,
    ),
    "weighted_calibration": (
        lambda ctx=None, **k: TM.WeightedCalibration(num_tasks=T, shard=ctx, device=CPU, **k),
        lambda ctx=None: JM.WeightedCalibration(num_tasks=T, shard=ctx),
        _feed_rows, WC_ROWS,
    ),
}


def _rank_stream(batches, rank, world=WORLD):
    return [batches[i] for i in range(rank, len(batches), world)]


def _value(out):
    return out[0] if isinstance(out, tuple) else out


@pytest.mark.parametrize("name", sorted(CASES))
def test_per_rank_shards_and_outboxes_bitwise_to_jax(name):
    make_t, make_j, feed, batches = CASES[name]
    for r in range(WORLD):
        tm, jm = make_t(TM.ShardContext(r, WORLD)), make_j(JM.ShardContext(r, WORLD))
        for b in _rank_stream(batches, r):
            feed(tm, b, _t)
            feed(jm, b, jnp.asarray)
        _assert_same_states(tm, jm)
        # the un-synced compute is the rank's local logical view
        assert _np(_value(tm.compute())).tobytes() == np.asarray(_value(jm.compute())).tobytes()


def _replicated_merge(make, feed, batches, to, world=WORLD):
    reps = [make() for _ in range(world)]
    for r in range(world):
        for b in _rank_stream(batches, r, world):
            feed(reps[r], b, to)
    target = copy.deepcopy(reps[0])
    target.merge_state(reps[1:])
    return _np(_value(target.compute()))


@pytest.mark.parametrize("name", sorted(CASES))
def test_reassembling_merge_bitwise_to_replicated_oracle_and_jax(name):
    make_t, make_j, feed, batches = CASES[name]
    shards = [make_t(TM.ShardContext(r, WORLD)) for r in range(WORLD)]
    jshards = [make_j(JM.ShardContext(r, WORLD)) for r in range(WORLD)]
    for r in range(WORLD):
        for b in _rank_stream(batches, r):
            feed(shards[r], b, _t)
            feed(jshards[r], b, jnp.asarray)
    target = copy.deepcopy(shards[0]).merge_state(shards[1:])
    jtarget = copy.deepcopy(jshards[0])
    jtarget.merge_state(jshards[1:])
    assert target._shard_rank == -1 and target._shard_world == 0
    _assert_same_states(target, jtarget)
    got = _np(_value(target.compute()))
    assert got.tobytes() == _replicated_merge(make_t, feed, batches, _t).tobytes()
    assert got.tobytes() == np.asarray(_value(jtarget.compute())).tobytes()


@pytest.mark.parametrize("name", sorted(CASES))
def test_threadworld_sync_and_adopt_bitwise_to_jax(name):
    make_t, make_j, feed, batches = CASES[name]

    def body(g):
        m = make_t(TM.ShardContext(g.rank, WORLD))
        for b in _rank_stream(batches, g.rank):
            feed(m, b, _t)
        value = _np(_value(toolkit.sync_and_compute(m, g)))
        synced = toolkit.adopt_synced(m, g)
        info = m._sharded_states
        state = next(iter(info))
        rows = info[state].logical_shape[0] // WORLD
        assert tuple(getattr(m, state).shape)[0] == rows and m._shard_rank == g.rank
        assert all(int(getattr(m, n.obh)) == 0 for n in m._routed_states.values())
        # a sync after the adopt does not count anything twice
        again = _np(_value(toolkit.sync_and_compute(m, g)))
        feed(m, batches[0], _t)
        return value, _np(_value(synced.compute())), again

    def jbody(g):
        m = make_j(JM.ShardContext(g.rank, WORLD))
        for b in _rank_stream(batches, g.rank):
            feed(m, b, jnp.asarray)
        return np.asarray(_value(jtoolkit.sync_and_compute(m, g)))

    want = JThreadWorld(WORLD).run(jbody)[0]
    for value, adopted, again in ThreadWorld(WORLD).run(body):
        assert value.tobytes() == adopted.tobytes() == again.tobytes() == want.tobytes()


def test_adopt_synced_rejects_replicated_metrics():
    def body(g):
        with pytest.raises(TypeError, match="double-count"):
            toolkit.adopt_synced(TM.MulticlassConfusionMatrix(C, device=CPU), g)
        with pytest.raises(TypeError, match="double-count"):
            toolkit.adopt_synced({"cm": TM.MulticlassConfusionMatrix(C, device=CPU)}, g)
        return True

    assert all(ThreadWorld(2).run(body))


def test_adopt_synced_collection_drains_every_member():
    def body(g):
        coll = {"cm": CASES["confusion_matrix"][0](TM.ShardContext(g.rank, 2)),
                "au": CASES["histogram_auroc"][0](TM.ShardContext(g.rank, 2))}
        toolkit.update_collection({"cm": coll["cm"]}, *map(_t, CM_BATCHES[g.rank]))
        coll["au"].update(*map(_t, AU_BATCHES[g.rank]))
        synced = toolkit.adopt_synced(coll, g)
        assert int(coll["cm"].confusion_matrix__obh) == int(coll["au"].hist__obh) == 0
        return int(synced["cm"].confusion_matrix.sum()), int(synced["au"].hist.sum())

    for cm_total, au_total in ThreadWorld(2).run(body):
        assert cm_total == 128 and au_total == int(sum((b[0] >= 0).sum() for b in AU_BATCHES[:2]))


def test_sync_payload_ships_shard_plus_trimmed_outbox():
    make_t, _, feed, batches = CASES["confusion_matrix"]
    sh, rep = make_t(TM.ShardContext(0, WORLD)), make_t()
    for b in _rank_stream(batches, 0):
        feed(sh, b, _t)
        feed(rep, b, _t)

    def nbytes(sd):
        return sum(v.numel() * v.element_size() if isinstance(v, torch.Tensor) else 8
                   for v in sd.values())

    assert nbytes(sh._sync_state_dict()) < nbytes(rep._sync_state_dict())
    cnt = int(sh.confusion_matrix__obh)
    assert sh._sync_state_dict()["confusion_matrix__obi"].shape[0] == 1 << (cnt - 1).bit_length()


def test_value_lane_payload_trims_outbox_and_bounds():
    make_t, _, feed, batches = CASES["weighted_calibration"]
    m = make_t(TM.ShardContext(2, WORLD))
    for b in batches[:3]:
        feed(m, b, _t)
    sd = m._sync_state_dict()
    names = m._routed_states["weighted_input_sum"]
    cnt, nb = int(getattr(m, names.obh)), int(getattr(m, names.obbh))
    assert sd[names.obi].shape[0] == sd[names.obv].shape[0] == 1 << (cnt - 1).bit_length()
    assert sd[names.obb].shape[0] == 1 << (nb - 1).bit_length()
    assert sd[names.obb][:nb].tolist() == [48, 96, 144]


def test_logical_payload_reslices_into_any_rank():
    make_t, _, feed, batches = CASES["confusion_matrix"]
    shards = [make_t(TM.ShardContext(r, WORLD)) for r in range(WORLD)]
    for r in range(WORLD):
        for b in _rank_stream(batches, r):
            feed(shards[r], b, _t)
    target = copy.deepcopy(shards[0]).merge_state(shards[1:])
    logical = target.confusion_matrix.numpy()
    rows = C // WORLD
    for r in range(WORLD):
        w = make_t(TM.ShardContext(r, WORLD))
        w.load_state_dict(target.state_dict())
        assert np.array_equal(w.confusion_matrix.numpy(), logical[r * rows:(r + 1) * rows])
        assert w._shard_rank == r and int(w.confusion_matrix__obh) == 0
    # a replicated writer's logical snapshot (no descriptor) reslices too
    w = make_t(TM.ShardContext(3, WORLD))
    w.load_state_dict(make_t().state_dict(), strict=False)
    assert tuple(w.confusion_matrix.shape) == (rows, C) and w._shard_rank == 3


@pytest.mark.parametrize("name", sorted(CASES))
def test_state_dict_cross_loads_both_ways(name):
    """A rank's carrier snapshot and a merged logical snapshot load from
    one package into the other, bitwise."""
    make_t, make_j, feed, batches = CASES[name]
    jm = make_j(JM.ShardContext(1, WORLD))
    for b in _rank_stream(batches, 1):
        feed(jm, b, jnp.asarray)
    tm = make_t(TM.ShardContext(1, WORLD))
    load_numpy_state_dict(tm, {k: np.asarray(v) for k, v in jm.state_dict().items()})
    _assert_same_states(tm, jm)
    back = make_j(JM.ShardContext(1, WORLD))
    back.load_state_dict({k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                          for k, v in numpy_state_dict(tm).items()})
    _assert_same_states(tm, back)
    # both keep updating alike
    for b in batches[:2]:
        feed(tm, b, _t)
        feed(back, b, jnp.asarray)
    _assert_same_states(tm, back)


def test_reset_restores_shard_defaults_and_descriptor():
    make_t, _, feed, batches = CASES["confusion_matrix"]
    m = make_t(TM.ShardContext(1, WORLD))
    for b in batches[:2]:
        feed(m, b, _t)
    m.reset()
    assert tuple(m.confusion_matrix.shape) == (C // WORLD, C) and not m.confusion_matrix.any()
    assert m._shard_rank == 1 and m._shard_world == WORLD and int(m.confusion_matrix__obh) == 0


def test_foreign_carrier_update_raises():
    m = TM.MulticlassConfusionMatrix(C, device=CPU, shard=TM.ShardContext(0, WORLD))
    m.load_state_dict(
        TM.MulticlassConfusionMatrix(C, device=CPU, shard=TM.ShardContext(3, WORLD))._sync_state_dict(),
        strict=False,
    )
    with pytest.raises(RuntimeError, match="foreign shard carriers"):
        m.update(*map(_t, CM_BATCHES[0]))


def test_indivisible_dimension_and_bad_contexts_raise():
    with pytest.raises(ValueError, match="does not divide evenly"):
        TM.MulticlassConfusionMatrix(10, device=CPU, shard=TM.ShardContext(0, 4))
    with pytest.raises(ValueError):
        TM.ShardContext(4, 4)
    with pytest.raises(ValueError):
        TM.ShardContext(0, 0)
    ctx = TM.ShardContext(1, 2)
    assert copy.deepcopy(ctx) is ctx and not ctx.is_mesh
    assert TM.ShardContext.from_group(type("G", (), {"rank": 1, "world_size": 2})()).rank == 1


def test_world1_shard_stays_on_dense_plans_and_interchanges():
    m = TM.MulticlassConfusionMatrix(C, device=CPU, shard=TM.ShardContext(0, 1))
    jm = JM.MulticlassConfusionMatrix(C, shard=JM.ShardContext(0, 1))
    for b in CM_BATCHES[:3]:
        m.update(*map(_t, b))
        jm.update(*map(jnp.asarray, b))
    assert int(m.confusion_matrix__obh) == 0 and tuple(m.confusion_matrix.shape) == (C, C)
    _assert_same_states(m, jm)


def test_update_collection_fuses_sharded_plans():
    oracle = TM.MulticlassConfusionMatrix(C, device=CPU)
    panel = {"cm": TM.MulticlassConfusionMatrix(C, device=CPU, shard=TM.ShardContext(0, WORLD)),
             "acc": TM.MulticlassAccuracy(device=CPU)}
    for b in _rank_stream(CM_BATCHES, 0):
        toolkit.update_collection(panel, *map(_t, b))
        oracle.update(*map(_t, b))
    assert torch.equal(panel["cm"].compute(), oracle.compute())


def test_sharded_window_reassembles_single_stream_oracle_and_jax():
    NT = 8
    stream = [(RNG.integers(0, 2, (NT, 16)).astype(np.float32),
               RNG.uniform(0.5, 2.0, (NT, 16)).astype(np.float32)) for _ in range(7)]
    oracle = TM.WindowedClickThroughRate(num_tasks=NT, max_num_updates=4, device=CPU)
    shs = [TM.WindowedClickThroughRate(num_tasks=NT, max_num_updates=4, device=CPU,
                                       shard=TM.ShardContext(r, WORLD)) for r in range(WORLD)]
    jshs = [JM.WindowedClickThroughRate(num_tasks=NT, max_num_updates=4,
                                        shard=JM.ShardContext(r, WORLD)) for r in range(WORLD)]
    for x, w in stream:
        oracle.update(_t(x), _t(w))
        for m, jm in zip(shs, jshs):
            m.update(_t(x), _t(w))
            jm.update(jnp.asarray(x), jnp.asarray(w))
    rows = NT // WORLD
    for r, (m, jm) in enumerate(zip(shs, jshs)):
        # the CTR kernel's weight sums reduce in another order than XLA's
        _assert_same_states(m, jm, rtol=1e-6)
        for name in ("windowed_click_total", "windowed_weight_total", "click_total"):
            assert torch.equal(getattr(m, name), getattr(oracle, name)[r * rows:(r + 1) * rows])
    lo, wo = oracle.compute()
    assert torch.equal(shs[1].compute()[1], wo[2:4])
    target = copy.deepcopy(shs[0]).merge_state(shs[1:])
    lm, wm = target.compute()
    assert lm.numpy().tobytes() == lo.numpy().tobytes()
    assert wm.numpy().tobytes() == wo.numpy().tobytes()


def test_weighted_calibration_dense_updates_are_owner_partitioned():
    x = RNG.uniform(size=(T, 12)).astype(np.float32)
    y = RNG.integers(0, 2, (T, 12)).astype(np.float32)
    rep = TM.WeightedCalibration(num_tasks=T, device=CPU).update(_t(x), _t(y))
    for r in range(WORLD):
        m = TM.WeightedCalibration(num_tasks=T, device=CPU, shard=TM.ShardContext(r, WORLD))
        jm = JM.WeightedCalibration(num_tasks=T, shard=JM.ShardContext(r, WORLD))
        m.update(_t(x), _t(y))
        jm.update(jnp.asarray(x), jnp.asarray(y))
        # the dense kernel's row sums reduce in another order than XLA's
        _assert_same_states(m, jm, rtol=1e-6)
        rows = slice(r * T // WORLD, (r + 1) * T // WORLD)
        assert torch.equal(m.weighted_input_sum, rep.weighted_input_sum[rows])


# --------------------------------------------------------- memory accounting


def test_memory_report_logical_vs_per_rank_columns():
    rep = memory_report({
        "sharded": TM.MulticlassConfusionMatrix(C, device=CPU, shard=TM.ShardContext(0, WORLD)),
        "replicated": TM.MulticlassConfusionMatrix(C, device=CPU),
    })
    srow, rrow = rep["sharded"], rep["replicated"]
    assert rrow["logical_bytes"] == rrow["per_rank_bytes"] and not rrow["sharded"]
    assert srow["sharded"] and srow["logical_bytes"] >= C * C * 4
    assert srow["per_rank_bytes"] <= srow["logical_bytes"] // WORLD + 64 * 1024


def test_acceptance_sizes_per_rank_bytes():
    """The JAX package's acceptance sizes: an 8,192-class matrix and a
    2^20-threshold histogram AUROC, sharded at world 4, pin at most
    logical/world + 64 KiB a rank."""
    cm = TM.MulticlassConfusionMatrix(8192, device=CPU, shard=TM.ShardContext(0, 4))
    row = memory_report({"cm": cm})["cm"]
    assert row["logical_bytes"] >= 8192 * 8192 * 4
    assert row["per_rank_bytes"] <= row["logical_bytes"] // 4 + 64 * 1024
    au = TM.HistogramBinnedAUROC(threshold=torch.linspace(0.0, 1.0, 1 << 20), device=CPU,
                                 shard=TM.ShardContext(0, 4))
    row = memory_report({"au": au})["au"]
    assert row["logical_bytes"] >= 2 * (1 << 20) * 4
    assert row["per_rank_bytes"] <= row["logical_bytes"] // 4 + 64 * 1024


# ---------------------------------------- shape bucketing x sharded plans


def test_bucketed_sharded_update_bitwise_to_oracle_and_jax():
    """Routed plans carry masked twins: ragged batches under bucketing
    merge bitwise to the unbucketed replicated oracle, each rank's outbox
    and cursor equal the JAX package's bucketed one, and the device
    cursor equals its host mirror."""
    from torcheval_tpu import config as jconfig

    make_t, make_j, feed, _ = CASES["confusion_matrix"]
    want = _replicated_merge(make_t, feed, RAGGED_CM, _t)
    with config.shape_bucketing():
        shards = [make_t(TM.ShardContext(r, WORLD)) for r in range(WORLD)]
        for r in range(WORLD):
            for b in _rank_stream(RAGGED_CM, r):
                feed(shards[r], b, _t)
        got = copy.deepcopy(shards[0]).merge_state(shards[1:]).compute().numpy()
    assert np.array_equal(got, want)
    with jconfig.shape_bucketing():
        jshards = [make_j(JM.ShardContext(r, WORLD)) for r in range(WORLD)]
        for r in range(WORLD):
            for b in _rank_stream(RAGGED_CM, r):
                feed(jshards[r], b, jnp.asarray)
    for m, jm in zip(shards, jshards):
        _assert_same_states(m, jm)
        assert int(m.confusion_matrix__obn) == int(m.confusion_matrix__obh)


@pytest.mark.parametrize("name", ["histogram_auroc", "weighted_calibration"])
def test_bucketed_routed_update_bitwise_to_unbucketed(name):
    make_t, _, feed, batches = CASES[name]
    ragged = [tuple(a[:n] for a in b) for b, n in zip(batches, (64, 30, 9, 17, 42, 5, 48, 33))]
    plain = [make_t(TM.ShardContext(r, 2)) for r in range(2)]
    with config.shape_bucketing():
        bucketed = [make_t(TM.ShardContext(r, 2)) for r in range(2)]
        for r in range(2):
            for b in _rank_stream(ragged, r, 2):
                feed(bucketed[r], b, _t)
    for r in range(2):
        for b in _rank_stream(ragged, r, 2):
            feed(plain[r], b, _t)
    a = copy.deepcopy(plain[0]).merge_state(plain[1:])
    b = copy.deepcopy(bucketed[0]).merge_state(bucketed[1:])
    assert _np(_value(a.compute())).tobytes() == _np(_value(b.compute())).tobytes()


def test_bucketed_sharded_update_captures_nothing_new_when_warmed():
    """Graph captures happen on the card, where chip_smoke's phase 16
    holds them to the bucket bound; on the CPU, a warmed sharded metric's
    bucketed plans keep one masked kernel object for every bucket and an
    outbox pre-sized once."""
    with config.shape_bucketing():
        m = TM.MulticlassConfusionMatrix(C, device=CPU, shard=TM.ShardContext(1, WORLD))
        shardspec.ensure_outbox_capacity(m, "confusion_matrix", 1024)
        kernels = set()
        for n in (8, 16, 32, 64, 6, 10, 18, 34):
            plan = m._update_plan(_t(RNG.integers(0, C, n)), _t(RNG.integers(0, C, n)))
            kernels.add(plan.masked_kernel)
            m._apply_update_plan(plan)
        with CompileCounter() as cc:
            m.update(_t(RNG.integers(0, C, 20)), _t(RNG.integers(0, C, 20)))
    assert len(kernels) == 1 and cc.programs == 0
    assert tuple(m.confusion_matrix__obi.shape) == (1024,)


def test_bucketed_outbox_capacity_admits_padded_write():
    with config.shape_bucketing():
        m = TM.MulticlassConfusionMatrix(C, device=CPU, shard=TM.ShardContext(1, WORLD))
        feed_n = 64 - 3
        m.update(_t(RNG.integers(0, C, feed_n)), _t(RNG.integers(0, C, feed_n)))
        cap_before = m.confusion_matrix__obi.shape[0]
        m.update(_t(RNG.integers(0, C, 5)), _t(RNG.integers(0, C, 5)))
        cap_after = m.confusion_matrix__obi.shape[0]
    assert cap_before == 64 and cap_after >= 69
    assert int(m.confusion_matrix__obh) == int(m.confusion_matrix__obn) == feed_n + 5


# ------------------------------------------------- elastic and checkpoints


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("new_world", [2, 4])
def test_elastic_world_change_resume_bitwise(tmp_path, name, new_world):
    """Snapshot sharded carriers at world 4, restore at world 2 or 4: the
    restore reassembles every old shard and outbox and re-slices, and the
    synced compute equals the uninterrupted world-4 sync bitwise."""
    make_t, _, feed, batches = CASES[name]
    directory = str(tmp_path / "bundle")

    def write(g):
        m = make_t(TM.ShardContext(g.rank, WORLD))
        for b in _rank_stream(batches, g.rank):
            feed(m, b, _t)
        session = ElasticSession({"m": m}, directory, process_group=g, interval=1)
        session.snapshot()
        session.close()
        return _np(_value(toolkit.sync_and_compute(m, g)))

    want = ThreadWorld(WORLD).run(write)[0]

    def read(g):
        m = make_t(TM.ShardContext(g.rank, new_world))
        session = ElasticSession({"m": m}, directory, process_group=g, interval=1)
        session.restore()
        session.close()
        assert m._shard_rank == g.rank and m._shard_world == new_world
        return _np(_value(toolkit.sync_and_compute(m, g)))

    for got in ThreadWorld(new_world).run(read):
        assert got.tobytes() == want.tobytes()


def test_checkpoint_validation_accepts_any_world_slice_and_rejects_others():
    m = TM.MulticlassConfusionMatrix(C, device=CPU, shard=TM.ShardContext(0, WORLD))
    ok = {k: v for k, v in numpy_state_dict(m).items()}
    ok["confusion_matrix"] = np.zeros((C // 2, C), np.int32)  # a world-2 slice
    validate_state_dict(m, ok, context="t")
    ok["confusion_matrix"] = np.zeros((C, C), np.int32)  # logical
    validate_state_dict(m, ok, context="t")
    for bad in (np.zeros((C // 2, C + 1), np.int32), np.zeros((C // 2, C), np.float32),
                np.zeros((2 * C, C), np.int32)):
        ok["confusion_matrix"] = bad
        with pytest.raises(RuntimeError, match="sharded state"):
            validate_state_dict(m, ok, context="t")
