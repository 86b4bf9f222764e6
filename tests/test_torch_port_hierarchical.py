"""``distributed.HierarchicalGroup`` against the JAX package's: the twins of
``tests/metrics/test_subgroups.py``'s hierarchy tests. The same seeded
numpy inputs go through both packages' ``ThreadWorld``s; results must be
bitwise equal to the flat gather, and the node/leader collective counts
equal to the JAX class's on the same partition."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as JM
from torcheval_tpu.distributed import HierarchicalGroup as JaxHierarchicalGroup
from torcheval_tpu.distributed import LocalReplicaGroup as JaxLocalReplicaGroup
from torcheval_tpu.metrics.toolkit import sync_and_compute as jax_sync_and_compute
from torcheval_tpu.utils.test_utils import ThreadWorld as JaxThreadWorld

import torcheval_tpu_torch.metrics as TM
from torcheval_tpu_torch.distributed import HierarchicalGroup, LocalReplicaGroup
from torcheval_tpu_torch.metrics import toolkit
from torcheval_tpu_torch.resilience import ResilientGroup
from torcheval_tpu_torch.utils.test_utils import ThreadWorld

CPU = "cpu"


def _samples(rank):
    rng = np.random.default_rng(rank)
    n = 20 + 10 * rank
    return rng.random(n).astype(np.float32), (rng.random(n) < 0.5).astype(np.float32)


def _port_metric(rank):
    s, y = _samples(rank)
    m = TM.BinaryAUROC(device=CPU)
    m.update(torch.from_numpy(s), torch.from_numpy(y))
    return m


def _jax_metric(rank):
    s, y = _samples(rank)
    m = JM.BinaryAUROC()
    m.update(jnp.asarray(s), jnp.asarray(y))
    return m


def _jax_counts(world, **partition):
    def body(g):
        hg = JaxHierarchicalGroup(g, **partition)
        v = float(np.asarray(jax_sync_and_compute(_jax_metric(g.rank), hg)))
        return v, hg.node_collectives, hg.leader_collectives

    return JaxThreadWorld(world).run(body)


@pytest.mark.parametrize(
    "world, partition",
    [
        (8, {"group_size": 4}),
        (8, {"group_size": 2}),
        (4, {"group_size": 2}),
        (4, {"group_size": 3}),
        (4, {"group_size": 1}),
        (4, {"groups": [[0, 2], [1, 3]]}),
        (4, {"groups": [[2, 3], [0, 1]]}),
    ],
    ids=["8/4", "8/2", "4/2", "4/3", "4/1", "explicit", "unsorted"],
)
def test_hierarchical_equals_flat_and_counts_like_jax(world, partition):
    flat = ThreadWorld(world).run(
        lambda g: toolkit.sync_and_compute(_port_metric(g.rank), g).numpy().tobytes()
    )

    def hier(g):
        hg = HierarchicalGroup(g, **partition)
        v = toolkit.sync_and_compute(_port_metric(g.rank), hg)
        return v.numpy().tobytes(), float(v), hg.node_collectives, hg.leader_collectives

    results = ThreadWorld(world).run(hier)
    jax_results = _jax_counts(world, **partition)
    for r in range(world):
        bits, value, node, leader = results[r]
        assert bits == flat[0]
        assert value == jax_results[r][0]
        assert (node, leader) == jax_results[r][1:], r


def test_hierarchical_explicit_groups_sum_matches_jax():
    def port(g):
        m = TM.Sum(device=CPU)
        m.update(torch.tensor(float(g.rank + 1)))
        return float(toolkit.sync_and_compute(m, HierarchicalGroup(g, groups=[[0, 2], [1, 3]])))

    def ref(g):
        m = JM.Sum()
        m.update(jnp.asarray(float(g.rank + 1)))
        return float(np.asarray(
            jax_sync_and_compute(m, JaxHierarchicalGroup(g, groups=[[0, 2], [1, 3]]))
        ))

    assert ThreadWorld(4).run(port) == JaxThreadWorld(4).run(ref) == [10.0] * 4


def test_hierarchical_unsorted_groups_keep_rank_order():
    def body(g):
        hg = HierarchicalGroup(g, groups=[[2, 3], [0, 1]])  # leaders 2, 0
        return hg.allgather_object(f"payload-from-rank-{g.rank}"), hg.allgather_array(
            np.full(3, g.rank, np.int32)
        )

    want = [f"payload-from-rank-{r}" for r in range(4)]
    for objs, arrays in ThreadWorld(4).run(body):
        assert objs == want
        assert [a.tolist() for a in arrays] == [[r] * 3 for r in range(4)]


@pytest.mark.parametrize(
    "kwargs, match",
    [
        ({"groups": [[0, 1], [1, 3]]}, "partition"),
        ({"groups": [[0, 1], [2]]}, "partition"),
        ({}, "group_size"),
        ({"group_size": 0}, "group_size"),
    ],
)
def test_rejected_partitions_raise_like_jax(kwargs, match):
    with pytest.raises(ValueError, match=match):
        JaxHierarchicalGroup(JaxThreadWorld(4).views[0], **kwargs)
    with pytest.raises(ValueError, match=match):
        HierarchicalGroup(ThreadWorld(4).views[0], **kwargs)


def test_local_replica_group_is_rejected_like_jax():
    with pytest.raises(ValueError, match="rank-per-process"):
        JaxHierarchicalGroup(JaxLocalReplicaGroup(jax.devices("cpu")[:1] * 4), group_size=2)
    with pytest.raises(ValueError, match="rank-per-process"):
        HierarchicalGroup(LocalReplicaGroup([CPU] * 4), group_size=2)


def test_hierarchical_over_subgroup_non_member_is_graceful():
    def body(g):
        sub = g.new_subgroup([0, 1])
        hg = HierarchicalGroup(sub, group_size=1)
        m = TM.Sum(device=CPU)
        m.update(torch.tensor(float(g.rank + 1)))
        tag = "member" if hg.is_member else "non-member"
        if not hg.is_member:
            with pytest.raises(RuntimeError, match="not a member"):
                hg.allgather_object(None)
        return tag, float(toolkit.sync_and_compute(m, hg))

    results = ThreadWorld(4).run(body)
    assert results[0] == ("member", 3.0) and results[1] == ("member", 3.0)
    assert results[2] == ("non-member", 3.0)
    assert results[3] == ("non-member", 4.0)


def test_hierarchical_inside_resilient_group_collection_sync():
    """The card phase's shape at a small size: a collection sync through
    ``ResilientGroup(HierarchicalGroup(group_size=2))`` equals the flat
    gather bitwise; each ``allgather`` of the sync is 2 node + (leaders)
    1 leader collectives."""

    def panel(rank):
        s, y = _samples(rank)
        coll = {"auroc": TM.BinaryAUROC(device=CPU), "ctr": TM.ClickThroughRate(device=CPU)}
        coll["auroc"].update(torch.from_numpy(s), torch.from_numpy(y))
        coll["ctr"].update(torch.from_numpy(y))
        return coll

    def values(out):
        return {k: v.numpy().tobytes() for k, v in out.items()}

    flat = ThreadWorld(4).run(lambda g: values(toolkit.sync_and_compute_collection(panel(g.rank), g)))

    def body(g):
        hg = HierarchicalGroup(g, group_size=2)
        rg = ResilientGroup(hg, timeout=30.0, policy="quorum")
        out = values(toolkit.sync_and_compute_collection(panel(g.rank), rg))
        return out, hg.node_collectives, hg.leader_collectives

    for r, (out, node, leader) in enumerate(ThreadWorld(4).run(body)):
        assert out == flat[0]
        assert node == 4 and leader == (2 if r in (0, 2) else 0)
