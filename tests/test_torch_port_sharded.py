"""In-step state sync over ``torch.distributed`` (``metrics/sharded.py``)
against the JAX package's eager merge, twins of
``tests/metrics/test_sharded.py``'s contracts.

Spawned gloo worlds of 1 and 2 ranks (one process each, a ``FileStore``
under ``tmp_path``) run ``sync_states_in_jit`` on every merge kind (SUM,
MAX, MIN, EXTEND with ``extend_valid``, owner-partitioned ``shard_specs``)
and ``donated_sync_step`` with a replicated and an owner-partitioned carry,
plus a sharded confusion matrix synced and adopted over ``MultiHostGroup``
and ``ShardContext.from_mesh`` on a gloo ``DeviceMesh``. Each result is
held bitwise to the JAX package's eager replicated merge
(``merge_state`` in rank order) of the same per-rank numpy data: the JAX
package's own donated-carry test needs an 8-device virtual mesh whose
``shard_map`` path fails on jax 0.9.0, so its eager merge is the
oracle.

The spawned ranks import this module, so JAX is imported inside the oracle
only: the ranks run the port alone.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.distributed as dist

import chip_smoke
import torcheval_tpu_torch.metrics as TM
from torcheval_tpu_torch.metrics import sharded, toolkit
from torcheval_tpu_torch.metrics.functional.classification.confusion_matrix import (
    _confusion_matrix_update_jit,
)
from torcheval_tpu_torch.metrics.metric import MergeKind
from torcheval_tpu_torch.metrics.shardspec import ShardSpec

C, STEPS, N = 8, 3, 40


def _batches(rank):
    rng = np.random.default_rng(200 + rank)
    return [
        (rng.standard_normal((N, C)).astype(np.float32), rng.integers(0, C, N))
        for _ in range(STEPS)
    ]


def _rank_metrics(P, rank, **kw):
    """One rank's replicated metrics fed its batches."""
    acc, mx, mn = P.MulticlassAccuracy(**kw), P.Max(**kw), P.Min(**kw)
    cm = P.MulticlassConfusionMatrix(C, **kw)
    for x, y in _batches(rank):
        for m in (acc, cm):
            m.update(x, y)
        mx.update(x.reshape(-1))
        mn.update(x.reshape(-1))
    return {"acc": acc, "max": mx, "min": mn, "cm": cm}


def _extend_buffer(rank):
    """An EXTEND buffer of capacity 16 holding ``5 + 3 * rank`` valid rows."""
    buf = np.full((16, 2), -1.0, np.float32)
    n = 5 + 3 * rank
    buf[:n] = np.arange(2 * n, dtype=np.float32).reshape(n, 2) + 100 * rank
    return buf


def _rank(rank, world, out_dir):
    from torcheval_tpu_torch.distributed import MultiHostGroup

    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(out_dir, "store"), world),
                            rank=rank, world_size=world)
    try:
        group = MultiHostGroup()
        ms = _rank_metrics(TM, rank, device="cpu")
        states = {
            "num_correct": ms["acc"].num_correct, "num_total": ms["acc"].num_total,
            "max": ms["max"].max, "min": ms["min"].min,
            "buf": torch.from_numpy(_extend_buffer(rank)),
            "cm": ms["cm"].confusion_matrix,
        }
        specs = dict(sharded.state_merge_specs(ms["acc"]), max=MergeKind.MAX,
                     min=MergeKind.MIN, buf=MergeKind.EXTEND, cm=MergeKind.SUM)
        before = {k: v.clone() for k, v in states.items()}
        synced = sharded.sync_states_in_jit(states, group, specs, extend_valid={"buf": 5 + 3 * (world - 1)},
                                            shard_specs={"cm": ShardSpec(0)})
        untouched = all(torch.equal(before[k], states[k]) for k in states)
        # a replicated carry (SUM + MAX) and an owner-partitioned one
        step = sharded.donated_sync_step(
            lambda x, y: {"n": torch.tensor([float(y.numel())]), "mx": x.amax().reshape(1)},
            group, {"n": MergeKind.SUM, "mx": MergeKind.MAX})
        carry = {"n": torch.zeros(1), "mx": torch.full((1,), -float("inf"))}
        ids = id(carry["n"])
        cm_step = sharded.donated_sync_step(
            lambda x, y: {"cm": _confusion_matrix_update_jit(torch.from_numpy(x), torch.from_numpy(y), C)},
            dist.group.WORLD, {"cm": MergeKind.SUM}, shard_specs={"cm": ShardSpec(0)})
        cm_carry = {"cm": torch.zeros((C // world, C), dtype=torch.int32)}
        for x, y in _batches(rank):
            carry = step(carry, torch.from_numpy(x), torch.from_numpy(y))
            cm_carry = cm_step(cm_carry, x, y)
        # a sharded confusion matrix over real processes: sync, adopt
        ctx = TM.ShardContext.from_group(group)
        shard_cm = TM.MulticlassConfusionMatrix(C, device="cpu", shard=ctx)
        for x, y in _batches(rank):
            shard_cm.update(torch.from_numpy(x), torch.from_numpy(y))
        cm_value = toolkit.sync_and_compute(shard_cm, group)
        toolkit.adopt_synced(shard_cm, group)
        mesh_ctx = None
        if world > 1:
            from torch.distributed.device_mesh import init_device_mesh

            mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("dp",))
            c = TM.ShardContext.from_mesh(mesh, "dp")
            mesh_ctx = (c.rank, c.world, c.is_mesh, c.mesh_axis)
        torch.save({
            "synced": synced, "untouched": untouched, "carry": carry,
            "in_place": id(carry["n"]) == ids, "cm_carry": cm_carry["cm"],
            "cm_value": cm_value, "adopted": (tuple(shard_cm.confusion_matrix.shape),
                                              int(shard_cm.confusion_matrix__obh)),
            "mesh": mesh_ctx,
        }, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _jax_oracle(world):
    """The JAX package's eager merge of the same per-rank metrics, in rank
    order: the replicated merge every sync must reproduce."""
    import torcheval_tpu.metrics as JM

    reps = [_rank_metrics(JM, r) for r in range(world)]
    merged = {}
    for name in reps[0]:
        target = reps[0][name]
        target.merge_state([reps[r][name] for r in range(1, world)])
        merged[name] = {k: np.asarray(v) for k, v in target.state_dict().items()}
    return merged


@pytest.mark.parametrize("world", [1, 2])
def test_in_step_sync_and_donated_carry_match_jax_eager_merge(world, tmp_path):
    with ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(chip_smoke._spawn_ranks, _rank, world, (str(tmp_path),), 180)
        want = _jax_oracle(world)
        spawned.result()
    bound = 5 + 3 * (world - 1)
    keep = 1 << (bound - 1).bit_length()
    rows = C // world
    for r in range(world):
        got = torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
        s = got["synced"]
        assert got["untouched"]
        for name in ("num_correct", "num_total"):
            assert s[name].numpy().tobytes() == want["acc"][name].tobytes(), name
        assert s["max"].numpy().tobytes() == want["max"]["max"].tobytes()
        assert s["min"].numpy().tobytes() == want["min"]["min"].tobytes()
        gathered = np.concatenate([_extend_buffer(q)[:keep] for q in range(world)])
        assert s["buf"].numpy().tobytes() == gathered.tobytes()
        logical = want["cm"]["confusion_matrix"]
        assert s["cm"].numpy().tobytes() == logical[r * rows:(r + 1) * rows].tobytes()
        assert got["cm_carry"].numpy().tobytes() == logical[r * rows:(r + 1) * rows].tobytes()
        assert got["in_place"] and float(got["carry"]["n"]) == float(STEPS * N * world)
        assert float(got["carry"]["mx"]) == float(want["max"]["max"])
        assert got["cm_value"].numpy().tobytes() == logical.tobytes()
        assert got["adopted"] == ((rows, C), 0)
        if world > 1:
            assert got["mesh"] == (r, world, False, "dp")


def test_state_merge_specs_and_tree_add():
    m = TM.MulticlassAccuracy(device="cpu")
    assert sharded.state_merge_specs(m) == {"num_correct": MergeKind.SUM,
                                            "num_total": MergeKind.SUM}
    out = sharded.tree_add({"a": torch.ones(2)}, {"a": torch.full((2,), 2.0)})
    assert out["a"].tolist() == [3.0, 3.0]


def test_unsupported_kinds_and_rungs_raise():
    with pytest.raises(NotImplementedError, match="SUM-kind"):
        sharded.donated_sync_step(lambda x: {"s": x}, None, {"s": MergeKind.MAX},
                                  shard_specs={"s": ShardSpec(axis=0)})
    with pytest.raises(NotImplementedError, match="reduce merge kinds"):
        sharded.donated_sync_step(lambda x: {"s": x}, None, {"s": MergeKind.EXTEND})
    # the lossy rungs are supported (test_lossy_rungs_match_the_jax_rungs);
    # an unknown rung still raises, at build and at call
    assert callable(sharded.donated_sync_step(lambda x: {"s": x}, None, compression="int8"))
    with pytest.raises(ValueError, match="unknown compression"):
        sharded.donated_sync_step(lambda x: {"s": x}, None, compression="fp4")
    with pytest.raises(ValueError, match="unknown compression"):
        sharded.sync_states_in_jit({"s": torch.zeros(4)}, None, compression="fp4")


# ----------------------------------------------------- the lossy rungs

LOSSY_N, LOSSY_ROWS = 700, 64


def _lossy_data(rank):
    """A rank's EXTEND buffer (capacity 1,024, 700 valid), its full-size
    float delta of an owner-partitioned (64, 8) state, and an int32
    counter: every float payload over the 1 KiB floor."""
    r = np.random.default_rng(300 + rank)
    buf = np.full((1024,), -np.inf, np.float32)
    buf[:LOSSY_N] = r.standard_normal(LOSSY_N).astype(np.float32) * (1 + rank)
    delta = r.standard_normal((LOSSY_ROWS, 8)).astype(np.float32)
    cnt = r.integers(0, 1000, 300).astype(np.int32)
    return buf, delta, cnt


def _lossy_rank(rank, world, out_dir, rung):
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(out_dir, f"store-{rung}"), world),
                            rank=rank, world_size=world)
    try:
        buf, delta, cnt = (torch.from_numpy(a) for a in _lossy_data(rank))
        synced = sharded.sync_states_in_jit(
            {"buf": buf, "cm": delta, "cnt": cnt}, None,
            {"buf": MergeKind.EXTEND, "cm": MergeKind.SUM, "cnt": MergeKind.SUM},
            extend_valid={"buf": LOSSY_N}, compression=rung, shard_specs={"cm": ShardSpec(0)})
        step = sharded.donated_sync_step(lambda d: {"cm": d}, None, {"cm": MergeKind.SUM},
                                         compression=rung, shard_specs={"cm": ShardSpec(0)})
        carry = {"cm": torch.zeros((LOSSY_ROWS // world, 8))}
        carry = step(carry, delta)
        torch.save({"synced": synced, "carry": carry["cm"]},
                   os.path.join(out_dir, f"lossy-{rung}-{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _jax_lossy(world, rung):
    """The JAX package's rungs on the virtual CPU mesh: the same per-rank
    data through ``sync_states_in_jit`` under ``shard_map``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as JP

    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map
    from torcheval_tpu.metrics.metric import MergeKind as JK
    from torcheval_tpu.metrics.sharded import sync_states_in_jit as jsync
    from torcheval_tpu.metrics.shardspec import ShardSpec as JSpec

    data = [_lossy_data(r) for r in range(world)]
    bufs = jnp.asarray(np.concatenate([d[0] for d in data]))
    deltas = jnp.asarray(np.concatenate([d[1] for d in data]))
    cnts = jnp.asarray(np.concatenate([d[2] for d in data]))

    def f(b, c, n):
        return jsync({"buf": b, "cm": c, "cnt": n}, "dp",
                     {"buf": JK.EXTEND, "cm": JK.SUM, "cnt": JK.SUM},
                     extend_valid={"buf": LOSSY_N}, compression=rung,
                     shard_specs={"cm": JSpec(0)})

    mesh = Mesh(np.array(jax.devices("cpu")[:world]), ("dp",))
    kw = {"check_vma": False}
    try:
        fn = shard_map(f, mesh=mesh, in_specs=(JP("dp"),) * 3,
                       out_specs={"buf": JP(), "cm": JP("dp"), "cnt": JP()}, **kw)
    except TypeError:
        fn = shard_map(f, mesh=mesh, in_specs=(JP("dp"),) * 3,
                       out_specs={"buf": JP(), "cm": JP("dp"), "cnt": JP()}, check_rep=False)
    out = jax.jit(fn)(bufs, deltas, cnts)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("rung", ["bf16", "int8"])
def test_lossy_rungs_match_the_jax_rungs(rung, tmp_path):
    """gloo world 2 against the JAX package's rung on a 2-device virtual
    mesh: the quantized EXTEND gather, the owner-partitioned sum and the
    donated carry bitwise; the integer counter exact; each float result
    within its codec bound of the exact sync."""
    from torcheval_tpu_torch import wire

    world = 2
    with ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(chip_smoke._spawn_ranks, _lossy_rank, world,
                              (str(tmp_path), rung), 180)
        want = _jax_lossy(world, rung)
        spawned.result()
    data = [_lossy_data(r) for r in range(world)]
    keep = 1 << (LOSSY_N - 1).bit_length()
    exact_buf = np.concatenate([d[0][:keep] for d in data])
    exact_cm = sum(d[1].astype(np.float64) for d in data)
    rows = LOSSY_ROWS // world
    for r in range(world):
        got = torch.load(tmp_path / f"lossy-{rung}-{r}.pt", weights_only=False)
        s = got["synced"]
        assert s["buf"].numpy().tobytes() == want["buf"].tobytes()
        own = want["cm"][r * rows:(r + 1) * rows]
        assert s["cm"].numpy().tobytes() == own.tobytes()
        assert got["carry"].numpy().tobytes() == own.tobytes()
        assert s["cnt"].numpy().tobytes() == want["cnt"].tobytes()
        assert s["cnt"].numpy().tobytes() == sum(d[2] for d in data).tobytes()
        finite = np.isfinite(exact_buf)
        err_buf = np.abs(s["buf"].numpy()[finite].astype(np.float64) - exact_buf[finite]).max()
        err_cm = np.abs(s["cm"].numpy() - exact_cm[r * rows:(r + 1) * rows]).max()
        if rung == "int8":
            assert err_buf <= max(wire.int8_error_bound(d[0][:keep][np.isfinite(d[0][:keep])], 32)
                                  for d in data)
            blocks = [d[1].reshape(world, -1)[r] for d in data]
            assert err_cm <= sum(wire.int8_error_bound(b, 32) for b in blocks) + 1e-6
        else:
            assert err_buf <= np.abs(exact_buf[finite]).max() * 2.0**-8
            assert err_cm <= np.abs(exact_cm).max() * 2.0**-7
