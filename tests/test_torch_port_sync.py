"""torcheval_tpu_torch sync over a 4-replica CPU LocalReplicaGroup
against the JAX package's LocalReplicaGroup result, plus the synclib wire
protocol (pack/unpack, sparse encoding, checksums, length encoding)."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as JM
from torcheval_tpu import distributed as jdist
from torcheval_tpu.metrics import synclib as jsynclib
from torcheval_tpu.metrics import toolkit as jtoolkit
import torcheval_tpu_torch.metrics as TM
from torcheval_tpu_torch import distributed as tdist
from torcheval_tpu_torch.metrics import synclib, toolkit

CPU = "cpu"
WORLD = 4
C = 10


def _batches(seed, n_batches=8):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        x = rng.standard_normal((64, C)).astype(np.float32)
        y = rng.integers(0, C, 64)
        s = rng.random(500).astype(np.float32)
        t = (rng.random(500) < s).astype(np.float32)
        out.append((x, y, s, t, np.float32(rng.random())))
    return out


def _collection(P, **kw):
    return {
        "acc": P.MulticlassAccuracy(**kw),
        "acc_macro": P.MulticlassAccuracy(average="macro", num_classes=C, **kw),
        "f1": P.MulticlassF1Score(average="macro", num_classes=C, **kw),
        "auroc": P.StreamingBinaryAUROC(num_bins=512, **kw),
        "auprc": P.StreamingBinaryAUPRC(num_bins=512, **kw),
        "loss": P.Mean(**kw),
        "tput": P.Throughput(**kw),
    }


def _replicas(P, tk, batches, **kw):
    reps = [_collection(P, **kw) for _ in range(WORLD)]
    for i, (x, y, s, t, loss) in enumerate(batches):
        coll = reps[i % WORLD]
        tk.update_collection({k: coll[k] for k in ("acc", "acc_macro", "f1")}, x, y)
        tk.update_collection({k: coll[k] for k in ("auroc", "auprc")}, s, t)
        coll["loss"].update(loss)
        coll["tput"].update(64, 0.5 + 0.1 * i)
    return reps


def _jax_group(world=WORLD):
    return jdist.LocalReplicaGroup(jax.devices("cpu")[:world])


def _torch_group(world=WORLD):
    return tdist.LocalReplicaGroup([torch.device(CPU)] * world)


def test_sync_and_compute_collection_matches_jax():
    batches = _batches(1)
    t = toolkit.sync_and_compute_collection(_replicas(TM, toolkit, batches, device=CPU), _torch_group())
    j = jtoolkit.sync_and_compute_collection(_replicas(JM, jtoolkit, batches), _jax_group())
    assert t.keys() == j.keys()
    for name in t:
        np.testing.assert_allclose(np.asarray(t[name]), np.asarray(j[name]), rtol=1e-6, err_msg=name)


def test_synced_states_bitwise_equal_jax_and_single_stream():
    batches = _batches(2)
    tsynced = toolkit.get_synced_metric_collection(_replicas(TM, toolkit, batches, device=CPU), _torch_group())
    jsynced = jtoolkit.get_synced_metric_collection(_replicas(JM, jtoolkit, batches), _jax_group())
    single = _collection(TM, device=CPU)
    for x, y, s, t, _ in batches:
        toolkit.update_collection({k: single[k] for k in ("acc", "acc_macro", "f1")}, x, y)
        toolkit.update_collection({k: single[k] for k in ("auroc", "auprc")}, s, t)
    for name in ("acc", "acc_macro", "f1", "auroc", "auprc"):
        for state in tsynced[name].state_dict():
            ours = getattr(tsynced[name], state)
            np.testing.assert_array_equal(ours.numpy(), np.asarray(getattr(jsynced[name], state)))
            assert torch.equal(ours, getattr(single[name], state)), (name, state)
    assert tsynced["tput"].num_total == jsynced["tput"].num_total == 64 * len(batches)
    assert tsynced["tput"].elapsed_time_sec == jsynced["tput"].elapsed_time_sec


def test_get_synced_metric_single_and_subgroup_match_jax():
    batches = _batches(3)
    treps = [c["acc_macro"] for c in _replicas(TM, toolkit, batches, device=CPU)]
    jreps = [c["acc_macro"] for c in _replicas(JM, jtoolkit, batches)]
    t = toolkit.get_synced_metric(treps, _torch_group())
    j = jtoolkit.get_synced_metric(jreps, _jax_group())
    np.testing.assert_array_equal(t.num_correct.numpy(), np.asarray(j.num_correct))
    tsub = _torch_group().new_subgroup([1, 2])
    jsub = _jax_group().new_subgroup([1, 2])
    t_val = toolkit.sync_and_compute(treps, tsub)
    j_val = jtoolkit.sync_and_compute(jreps, jsub)
    np.testing.assert_allclose(t_val.numpy(), np.asarray(j_val), rtol=1e-6)
    assert torch.equal(toolkit.sync_and_compute(treps[1:3], tsub), t_val)


def test_replica_count_mismatch_raises():
    reps = [TM.Mean(device=CPU) for _ in range(3)]
    with pytest.raises(ValueError, match="world_size"):
        toolkit.sync_and_compute(reps, _torch_group())
    with pytest.raises(TypeError, match="per-replica list"):
        toolkit.sync_and_compute(reps[0], _torch_group())


def test_world_of_one_returns_the_input():
    m = TM.Mean(device=CPU).update(np.float32(3.0))
    assert toolkit.get_synced_metric(m) is m
    assert float(toolkit.sync_and_compute(m, tdist.SingleProcessGroup())) == 3.0


def _states():
    rng = np.random.default_rng(4)
    sparse = np.zeros((2, 2, 2048), np.float32)
    sparse[0, 0, rng.integers(0, 2048, 20)] = 1.0
    sparse[1, 1, 5] = -0.0  # a bit-nonzero zero must survive
    return {
        "b": {"hist": torch.from_numpy(sparse), "n": 7, "x": 0.25},
        "a": {
            "dense": torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)),
            "items": [torch.arange(4), torch.ones(2, dtype=torch.float64)],
            "table": {"k1": torch.tensor(1.5), "k0": torch.tensor(-2.0)},
            "i32": torch.tensor([1, 2, 3], dtype=torch.int32),
        },
    }


def test_traversal_order_matches_jax():
    states = _states()
    assert synclib.metrics_traversal_order(states) == jsynclib.metrics_traversal_order(states)


def test_pack_unpack_round_trip_is_exact_and_sparse_when_it_pays():
    states = _states()
    order = synclib.metrics_traversal_order(states)
    meta, flat = synclib._pack_rank_states(states, order)
    hist_meta = meta[order.index(("b", "hist"))]
    assert hist_meta[1][0][2][0] == "sparse"
    assert flat.nbytes < 2 * 2 * 2048 * 4 // 4
    out = synclib._unpack_rank_states(states, order, meta, flat)
    for metric, sd in states.items():
        for name, value in sd.items():
            got = out[metric][name]
            if isinstance(value, torch.Tensor):
                np.testing.assert_array_equal(got.view(np.uint8), value.numpy().view(np.uint8))
                assert got.dtype == value.numpy().dtype
            elif isinstance(value, list):
                for g, v in zip(got, value):
                    np.testing.assert_array_equal(g, v.numpy())
            elif isinstance(value, dict):
                assert sorted(got) == sorted(value)
                for k in value:
                    np.testing.assert_array_equal(got[k], value[k].numpy())
            else:
                assert got == value


def test_corrupt_payload_is_refused():
    class Corrupting(tdist.LocalReplicaGroup):
        def allgather_array(self, xs):
            bufs = [np.array(x, copy=True) for x in super().allgather_array(xs)]
            bufs[1][0] ^= 0xFF
            return bufs

    reps = [TM.StreamingBinaryAUROC(num_bins=64, device=CPU).update(np.float32([0.3]), np.float32([1])) for _ in range(2)]
    with pytest.raises(RuntimeError, match="checksum"):
        toolkit.sync_and_compute(reps, Corrupting([torch.device(CPU)] * 2))


@pytest.mark.parametrize("n", [0, 1, 2**31 - 1, 2**31, 2**40 + 12345, 2**62 - 1])
def test_encode_length_matches_jax(n):
    enc = tdist.encode_length(n)
    np.testing.assert_array_equal(enc, jdist.encode_length(n))
    assert enc.dtype == np.int32
    assert tdist.decode_length(enc) == n


@pytest.mark.parametrize("n", [-1, 2**62])
def test_encode_length_rejects_out_of_range(n):
    with pytest.raises(ValueError):
        tdist.encode_length(n)
