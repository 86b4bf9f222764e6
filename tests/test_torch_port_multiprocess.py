"""Multi-process sync of the port: spawned gloo worlds of 2 and 4 ranks (one
process each, joined through a ``FileStore`` under ``tmp_path``) sync a
collection of every ported class, buffered ones included, over
``MultiHostGroup``. Every rank's synced values and states are held against
the JAX package's ``LocalReplicaGroup`` merge oracle on the same per-rank
data (curve arrays, counters and buffers bitwise; AUROC/AUPRC/recall
scalars and float sums within 1e-6). Also pinned: one ``allgather_object``
plus at most one ``allgather_array`` per collection sync, subgroups with
non-members, ``get_synced_state_dict(_collection)``, ``classwise_converter``,
``default_process_group``, and the DDP-style example at world 2.

The spawned ranks import this module, so JAX is imported inside the oracle
only: the ranks run the port alone."""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.distributed as dist

import chip_smoke
import torcheval_tpu_torch.metrics as TM
from torcheval_tpu_torch import distributed as tdist
from torcheval_tpu_torch.examples import distributed_example
from torcheval_tpu_torch.metrics import toolkit

C, L = 6, 4
SUBGROUP = {2: [1], 4: [1, 3]}
FLOAT_SUMS = ("loss", "total")  # float32 sums: the packages reduce a batch in different orders
CURVES = ("prc", "mc_prc", "ml_prc")  # curve arrays of exact counts: bitwise


def _collection(P, **kw):
    return {
        "acc": P.MulticlassAccuracy(**kw),
        "acc_macro": P.MulticlassAccuracy(average="macro", num_classes=C, **kw),
        "f1": P.MulticlassF1Score(average=None, num_classes=C, **kw),
        "bacc": P.BinaryAccuracy(**kw),
        "bf1": P.BinaryF1Score(**kw),
        "loss": P.Mean(**kw),
        "total": P.Sum(**kw),
        "tput": P.Throughput(**kw),
        "sauroc": P.StreamingBinaryAUROC(num_bins=128, **kw),
        "sauprc": P.StreamingBinaryAUPRC(num_bins=128, **kw),
        "auroc": P.BinaryAUROC(**kw),
        "auroc_fused": P.BinaryAUROC(use_fused=True, **kw),
        "auprc": P.BinaryAUPRC(**kw),
        "mc_auroc": P.MulticlassAUROC(num_classes=C, **kw),
        "mc_auprc": P.MulticlassAUPRC(num_classes=C, average=None, **kw),
        "ml_auprc": P.MultilabelAUPRC(num_labels=L, **kw),
        "prc": P.BinaryPrecisionRecallCurve(**kw),
        "mc_prc": P.MulticlassPrecisionRecallCurve(num_classes=C, **kw),
        "ml_prc": P.MultilabelPrecisionRecallCurve(num_labels=L, **kw),
        "rafp": P.BinaryRecallAtFixedPrecision(min_precision=0.5, **kw),
        "ml_rafp": P.MultilabelRecallAtFixedPrecision(num_labels=L, min_precision=0.5, **kw),
    }


def _feed(coll, rank):
    """Rank ``rank``'s data: a different sample count on every rank, so
    the buffers' capacities differ across ranks (64, 128, 256, ...)."""
    rng = np.random.default_rng(100 + rank)
    n = 30 + 45 * rank
    x = rng.standard_normal((n, C)).astype(np.float32)
    y = rng.integers(0, C, n)
    s = (np.round(rng.random(n) * 20) / 20).astype(np.float32)
    t = (rng.random(n) < s).astype(np.int64)
    ms = (np.round(rng.random((n, L)) * 10) / 10).astype(np.float32)
    mt = (rng.random((n, L)) < ms).astype(np.int64)
    for k in ("acc", "acc_macro", "f1", "mc_auroc", "mc_auprc", "mc_prc"):
        coll[k].update(x, y)
    for k in ("bacc", "bf1", "sauroc", "sauprc", "auroc", "auroc_fused", "auprc", "prc", "rafp"):
        coll[k].update(s, t)
    for k in ("ml_auprc", "ml_prc", "ml_rafp"):
        coll[k].update(ms, mt)
    coll["loss"].update(s)
    coll["total"].update(s)
    coll["tput"].update(n, 0.5 + rank)
    return coll


class _CountingGroup(tdist.MultiHostGroup):
    """The world group, counting its gathers."""

    def __init__(self):
        super().__init__()
        self.calls = {"object": 0, "array": 0}

    def allgather_object(self, obj):
        self.calls["object"] += 1
        return super().allgather_object(obj)

    def allgather_array(self, x):
        self.calls["array"] += 1
        return super().allgather_array(x)


def _computed(coll):
    return {name: m.compute() for name, m in coll.items()}


def _rank(rank, world, out_dir):
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(out_dir, "store"), world),
                            rank=rank, world_size=world)
    try:
        coll = _feed(_collection(TM, device="cpu"), rank)
        group = _CountingGroup()
        synced = toolkit.get_synced_metric_collection(coll, group)
        calls = dict(group.calls)
        values = _computed(synced)
        again = toolkit.sync_and_compute_collection(coll, group)
        state_dicts = toolkit.get_synced_state_dict_collection(coll, group)
        auroc_state = toolkit.get_synced_state_dict(coll["auroc"], group)
        default = toolkit.default_process_group()
        sub = group.new_subgroup(SUBGROUP[world])
        before = {name: m.state_dict() for name, m in coll.items()}
        sub_synced = toolkit.get_synced_metric_collection(coll, sub)
        untouched = sub_synced is coll and all(
            chip_smoke._same_state(v, getattr(coll[name], k))
            for name, sd in before.items() for k, v in sd.items())
        torch.save({
            "calls": calls, "values": values, "again": again, "state_dicts": state_dicts,
            "auroc_state": auroc_state, "default": (type(default).__name__, default.world_size,
                                                    default.rank),
            "sub": (sub.is_member, sub.world_size, sub.ranks, sub.rank),
            "sub_values": _computed(sub_synced) if sub.is_member else None,
            "untouched": untouched,
            "classwise": toolkit.classwise_converter(values["mc_auprc"], "auprc",
                                                     [f"c{i}" for i in range(C)]),
        }, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _jax_oracle(world):
    """The JAX package's LocalReplicaGroup merge of the same per-rank data:
    (synced values, synced state dicts, subgroup values)."""
    import jax

    import torcheval_tpu.metrics as JM
    from torcheval_tpu import distributed as jdist
    from torcheval_tpu.metrics import toolkit as jtoolkit

    group = jdist.LocalReplicaGroup(jax.devices("cpu")[:world])
    replicas = [_feed(_collection(JM), r) for r in range(world)]  # a sync leaves them as they are
    synced = jtoolkit.get_synced_metric_collection(replicas, group)
    sub = jtoolkit.sync_and_compute_collection(replicas, group.new_subgroup(SUBGROUP[world]))
    return _computed(synced), {name: m.state_dict() for name, m in synced.items()}, sub


def _leaves(value):
    if isinstance(value, (list, tuple)):
        return [leaf for v in value for leaf in _leaves(v)]
    return [np.asarray(value.numpy() if isinstance(value, torch.Tensor) else value)]


def _assert_values(got, want):
    for name in want:
        g, w = _leaves(got[name]), _leaves(want[name])
        assert len(g) == len(w), name
        for a, b in zip(g, w):
            assert a.shape == b.shape, name
            if name in CURVES:
                assert a.tobytes() == b.tobytes(), name
            else:
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=name)


def _assert_states(got, want):
    for name, sd in want.items():
        assert sorted(got[name]) == sorted(sd), name
        for k, v in sd.items():
            ours = got[name][k]
            if not isinstance(ours, torch.Tensor):
                assert ours == v, (name, k)
                continue
            v = np.asarray(v)
            assert ours.numpy().dtype == v.dtype and ours.shape == v.shape, (name, k)
            if name in FLOAT_SUMS:
                np.testing.assert_allclose(ours.numpy(), v, rtol=1e-6, err_msg=f"{name}.{k}")
            else:
                assert ours.numpy().tobytes() == v.tobytes(), (name, k)


@pytest.mark.parametrize("world", [2, 4])
def test_spawned_world_syncs_every_class_to_the_jax_oracle(world, tmp_path):
    with ThreadPoolExecutor(1) as pool:  # the oracle computes while the ranks run
        spawned = pool.submit(chip_smoke._spawn_ranks, _rank, world, (str(tmp_path),), 180)
        want_values, want_states, want_sub = _jax_oracle(world)
        spawned.result()
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(world)]
    sub_ranks = SUBGROUP[world]
    for r, got in enumerate(ranks):
        assert got["calls"] == {"object": 1, "array": 1}, r
        _assert_values(got["values"], want_values)
        _assert_values(got["again"], want_values)
        _assert_states(got["state_dicts"], want_states)
        _assert_states({"auroc": got["auroc_state"]}, {"auroc": want_states["auroc"]})
        assert got["default"] == ("MultiHostGroup", world, r)
        member = r in sub_ranks
        assert got["sub"] == (member, len(sub_ranks), tuple(sub_ranks),
                              sub_ranks.index(r) if member else -1)
        if member:
            _assert_values(got["sub_values"], want_sub)
        assert got["untouched"] == (not member or len(sub_ranks) == 1)
        assert list(got["classwise"]) == [f"auprc_c{i}" for i in range(C)]
        np.testing.assert_array_equal(
            np.stack([v.numpy() for v in got["classwise"].values()]), got["values"]["mc_auprc"].numpy())
        # every rank merges the same ranks in the same order: the same bits
        for name, value in got["values"].items():
            for a, b in zip(_leaves(value), _leaves(ranks[0]["values"][name])):
                assert a.tobytes() == b.tobytes(), (r, name)


def test_non_member_issues_no_collective():
    group = tdist.MultiHostGroup.__new__(tdist.MultiHostGroup)
    group._group, group._ranks, group._index = None, (1, 2), None
    assert not group.is_member and group.rank == -1 and group.ranks == (1, 2)
    coll = {"m": TM.Mean(device="cpu").update(np.float32(2.0))}
    assert toolkit.get_synced_metric_collection(coll, group) is coll
    assert float(toolkit.sync_and_compute(coll["m"], group)) == 2.0


def test_multi_host_group_needs_torch_distributed():
    if dist.is_initialized():
        pytest.skip("torch.distributed is initialized in this process")
    with pytest.raises(RuntimeError, match="init_process_group"):
        tdist.MultiHostGroup()
    assert isinstance(tdist.default_process_group(), tdist.SingleProcessGroup)


def test_distributed_example_at_world_2_on_cpu():
    values = distributed_example.main(world=2, device="cpu", steps=8, sync_every=4)
    assert len(values) == 2 and values[0] == values[1]
    assert 0.0 <= values[0]["accuracy"] <= 1.0 and 0.0 <= values[0]["auroc"] <= 1.0
    assert values[0]["throughput"] > 0
