"""torcheval_tpu_torch's fault-tolerant sync against the JAX package's:
``resilience.ResilientGroup`` and its policies, ``SyncHealth``,
``backoff_delay``, the ``FaultInjectionGroup``/``ThreadWorld``/
``DeterministicScheduler`` harnesses, ``synclib``'s partial
participation, the toolkit's ``on_failure=`` and ``sync_provenance``, and
``config``'s sync knobs.

The twins of ``tests/metrics/test_fault_injection.py`` run each scripted
fault on the port; the cross-package tests run the same faults in both
packages on the same seeded numpy replicas and require equal
``SyncProvenance``, equal ``SyncHealth.as_dict()`` (``last_good_sync``, a
timestamp, excepted) and bitwise-equal values (the replicas' data is
integer-valued or the metrics count, so every merge is exact).

Deadlines stay at or under 2 s and sleeps at or under 0.5 s.
"""

from __future__ import annotations

import copy
import os
import random
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as JM
from torcheval_tpu import config as jconfig
from torcheval_tpu import distributed as jdist
from torcheval_tpu import resilience as jres
from torcheval_tpu.metrics import toolkit as jtoolkit
from torcheval_tpu.utils import test_utils as jtu
import torcheval_tpu_torch.metrics as TM
from torcheval_tpu_torch import config
from torcheval_tpu_torch import distributed as tdist
from torcheval_tpu_torch import resilience
from torcheval_tpu_torch.metrics import synclib, toolkit
from torcheval_tpu_torch.metrics.toolkit import get_synced_metric, sync_and_compute
from torcheval_tpu_torch.ops import _kernels
from torcheval_tpu_torch.resilience import (
    DEFAULT_DEGRADING_TIMEOUT,
    PartialGatherError,
    ResilientGroup,
    SyncHealth,
    SyncIntegrityError,
    SyncProvenance,
    SyncTimeoutError,
    backoff_delay,
    bounded_call,
    default_sync_health,
)
from torcheval_tpu_torch.utils.test_utils import (
    DeadlockError,
    DeterministicScheduler,
    FaultInjectionGroup,
    FaultSpec,
    ScheduleResult,
    ThreadWorld,
)

CPU = "cpu"
WORLD = 3
THIS = sys.modules[__name__]


@pytest.fixture(autouse=True)
def _drain_abandoned_collectives():
    """The in-flight fence is per caller thread: drain this test's
    abandoned stragglers so they cannot fence the next test's gathers."""
    yield
    assert not resilience._still_in_flight(5.0), "an abandoned collective outlived its test"


# ------------------------------------------------------------------ data


def _make(P, name):
    kw = {"device": CPU} if P is TM else {}
    if name == "WindowedMeanSquaredError":
        return P.WindowedMeanSquaredError(max_num_updates=2, **kw)
    return getattr(P, name)(**kw)


def _feed(m, name, rank, updates=2):
    """Integer-valued float data, so every merge is exact in any order."""
    rng = np.random.default_rng(100 + rank)
    for _ in range(updates):
        x = rng.integers(0, 8, (16, 4)).astype(np.float32)
        y = rng.integers(0, 4, 16)
        if name == "MulticlassAccuracy":
            m.update(x, y)
        elif name == "Sum":
            m.update(x[:, 0])
        elif name == "BinaryAUROC":
            m.update(x[:, 0] / 8, (y == 0).astype(np.float32))
        elif name == "WindowedMeanSquaredError":
            m.update(x[:, 0], x[:, 1])
    return m


def _replicas(name="MulticlassAccuracy", world=WORLD, P=TM):
    return [_feed(_make(P, name), name, r) for r in range(world)]


def _local_group(world=WORLD):
    return tdist.LocalReplicaGroup([torch.device(CPU)] * world)


def _jax_group(world=WORLD):
    return jdist.LocalReplicaGroup(jax.devices("cpu")[:world])


def _copies(replicas):
    return [copy.deepcopy(m) for m in replicas]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _merge_oracle(replicas, ranks):
    survivors = [copy.deepcopy(replicas[r]) for r in ranks]
    return survivors[0].merge_state(survivors[1:])


def _assert_same_state(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        va, vb = sa[k], sb[k]
        if isinstance(va, torch.Tensor):
            assert va.dtype == vb.dtype and torch.equal(va, vb), k
        else:
            assert va == vb, k


# --------------------------------------------------------------- happy path


class _CountingGroup(tdist.ProcessGroup):
    """Two fake ranks, both holding this process's payload; counts calls."""

    def __init__(self):
        self.object_gathers = 0
        self.array_gathers = 0

    @property
    def world_size(self):
        return 2

    @property
    def rank(self):
        return 0

    def allgather_object(self, obj):
        self.object_gathers += 1
        return [obj, copy.deepcopy(obj)]

    def allgather_array(self, x):
        self.array_gathers += 1
        x = np.asarray(x)
        return [x, x.copy()]


def test_happy_path_zero_extra_collectives_and_same_value():
    metric = _replicas(world=1)[0]
    plain = _CountingGroup()
    want = sync_and_compute(copy.deepcopy(metric), plain)
    counting = _CountingGroup()
    group = ResilientGroup(counting, timeout=2.0, retries=2, policy="quorum")
    got = sync_and_compute(copy.deepcopy(metric), group)
    assert counting.object_gathers == plain.object_gathers == 1
    assert counting.array_gathers == plain.array_gathers <= 1
    assert torch.equal(got, want)
    assert group.health.full_syncs == 1
    assert group.health.degraded_syncs == 0
    assert group.health.participating_ranks == (0, 1)
    assert group.health.last_good_sync is not None


def test_happy_path_local_replicas_unchanged_by_wrapping():
    replicas = _replicas()
    want = sync_and_compute(_copies(replicas), _local_group())
    group = ResilientGroup(FaultInjectionGroup(_local_group()), timeout=2.0, policy="quorum")
    got = sync_and_compute(_copies(replicas), group)
    assert torch.equal(got, want)
    assert group.health.participating_ranks == tuple(range(WORLD))


# ------------------------------------------------------------ dead rank


def test_quorum_merges_surviving_ranks_within_deadline():
    replicas = _replicas()
    chaos = FaultInjectionGroup(_local_group(), dead_ranks={1})
    group = ResilientGroup(chaos, timeout=2.0, retries=1, policy="quorum", backoff_base=0.0)
    start = time.monotonic()
    synced = get_synced_metric(_copies(replicas), group)
    assert time.monotonic() - start < 3.0
    _assert_same_state(synced, _merge_oracle(replicas, [0, 2]))
    assert synced.sync_provenance.ranks == (0, 2)
    assert synced.sync_provenance.degraded
    assert synced.sync_provenance.policy == "quorum"
    assert group.health.partial_gathers >= 1
    assert group.health.degraded_syncs == 1
    assert group.health.participating_ranks == (0, 2)
    assert group.health.last_good_sync is None


def test_raise_policy_dead_rank_is_typed_not_a_hang():
    chaos = FaultInjectionGroup(_local_group(), dead_ranks={1})
    group = ResilientGroup(chaos, timeout=2.0, retries=1, policy="raise", backoff_base=0.0)
    start = time.monotonic()
    with pytest.raises(SyncTimeoutError):
        sync_and_compute(_copies(_replicas()), group)
    assert time.monotonic() - start < 3.0


def test_raise_policy_slow_peer_times_out_typed():
    chaos = FaultInjectionGroup(
        _local_group(), faults=[FaultSpec(call=0, kind="delay", seconds=0.5, times=99)]
    )
    group = ResilientGroup(chaos, timeout=0.05, retries=1, policy="raise", backoff_base=0.0)
    start = time.monotonic()
    with pytest.raises(SyncTimeoutError):
        sync_and_compute(_copies(_replicas()), group)
    assert time.monotonic() - start < 2.0
    assert group.health.timeouts == 2
    assert chaos.calls == 1  # the timed-out gather was waited on, never reissued


def test_late_completion_harvested_instead_of_reissued():
    replicas = _replicas()
    chaos = FaultInjectionGroup(
        _local_group(), faults=[FaultSpec(call=0, kind="delay", seconds=0.15, times=2)]
    )
    group = ResilientGroup(chaos, timeout=0.05, retries=2, policy="raise", backoff_base=0.1)
    want = sync_and_compute(_copies(replicas), _local_group())
    got = sync_and_compute(_copies(replicas), group)
    assert torch.equal(got, want)
    assert group.health.timeouts >= 1
    assert chaos.calls == 2


def _worker_count():
    return sum(t.name.startswith("torcheval-sync") and t.is_alive() for t in threading.enumerate())


def test_auto_wrapped_syncs_do_not_leak_worker_threads():
    replicas = _replicas()
    before = _worker_count()
    with config.sync_resilience(timeout=2.0, degradation="quorum"):
        for _ in range(25):
            sync_and_compute(_copies(replicas), _local_group())
    assert _worker_count() - before <= 1


def test_in_flight_collective_fences_the_next_one():
    replicas = _replicas()
    chaos = FaultInjectionGroup(
        _local_group(), faults=[FaultSpec(call=0, kind="delay", seconds=0.4, times=1)]
    )
    group = ResilientGroup(chaos, timeout=0.05, retries=0, policy="local", backoff_base=0.0)
    synced = get_synced_metric(_copies(replicas), group)
    assert synced.sync_provenance.ranks == (0,)
    assert chaos.calls == 1  # the payload gather was fenced, never issued
    time.sleep(0.45)  # the straggler lands
    synced2 = get_synced_metric(_copies(replicas), group)
    assert synced2.sync_provenance.ranks == tuple(range(WORLD))
    assert chaos.calls == 3


def test_timed_out_worker_threads_are_daemons():
    chaos = FaultInjectionGroup(
        _local_group(), faults=[FaultSpec(call=0, kind="delay", seconds=0.3, times=1)]
    )
    group = ResilientGroup(chaos, timeout=0.02, retries=0, policy="local", backoff_base=0.0)
    _, ranks = group.allgather_object_with_ranks(["a", "b", "c"])
    assert ranks == [0]
    stuck = [t for t in threading.enumerate() if t.name.startswith("torcheval-sync")]
    assert stuck and all(t.daemon for t in stuck)


def test_local_policy_falls_back_to_own_state_flagged_stale():
    replicas = _replicas()
    chaos = FaultInjectionGroup(_local_group(), dead_ranks={1})
    group = ResilientGroup(chaos, timeout=2.0, retries=0, policy="local", backoff_base=0.0)
    synced = get_synced_metric(_copies(replicas), group)
    assert torch.equal(synced.compute(), copy.deepcopy(replicas[0]).compute())
    assert synced.sync_provenance.ranks == (0,)
    assert synced.sync_provenance.degraded


def test_quorum_not_met_raises():
    chaos = FaultInjectionGroup(_local_group(4), dead_ranks={1, 2, 3})
    group = ResilientGroup(
        chaos, timeout=2.0, retries=0, policy="quorum", quorum=0.75, backoff_base=0.0
    )
    with pytest.raises(SyncTimeoutError, match="quorum"):
        sync_and_compute(_copies(_replicas(world=4)), group)


# ------------------------------------------------------- transient + retry


def test_transient_fault_is_retried_to_full_participation():
    replicas = _replicas()
    chaos = FaultInjectionGroup(_local_group(), faults=[FaultSpec(call=0, kind="transient")])
    group = ResilientGroup(chaos, timeout=2.0, retries=2, policy="raise", backoff_base=0.0)
    want = sync_and_compute(_copies(replicas), _local_group())
    got = sync_and_compute(_copies(replicas), group)
    assert torch.equal(got, want)
    assert group.health.transient_errors == 1
    assert group.health.retries == 1
    assert group.health.full_syncs == 1
    assert group.health.participating_ranks == tuple(range(WORLD))


def test_transient_drop_recovers_on_retry():
    chaos = FaultInjectionGroup(_local_group(), faults=[FaultSpec(call=0, kind="drop", rank=2)])
    group = ResilientGroup(chaos, timeout=2.0, retries=2, policy="raise", backoff_base=0.0)
    synced = get_synced_metric(_copies(_replicas()), group)
    assert synced.sync_provenance.ranks == tuple(range(WORLD))
    assert not synced.sync_provenance.degraded
    assert group.health.partial_gathers == 1


# ------------------------------------------------------------- corruption


def test_corrupt_payload_dropped_under_quorum():
    replicas = _replicas()
    chaos = FaultInjectionGroup(_local_group(), faults=[FaultSpec(call=1, kind="corrupt", rank=1)])
    group = ResilientGroup(chaos, timeout=2.0, retries=0, policy="quorum", backoff_base=0.0)
    synced = get_synced_metric(_copies(replicas), group)
    assert synced.sync_provenance.ranks == (0, 2)
    _assert_same_state(synced, _merge_oracle(replicas, [0, 2]))
    assert group.health.corrupt_payloads == 1


def test_corrupt_payload_raises_under_raise_policy():
    chaos = FaultInjectionGroup(_local_group(), faults=[FaultSpec(call=1, kind="corrupt", rank=1)])
    group = ResilientGroup(chaos, timeout=2.0, retries=0, policy="raise", backoff_base=0.0)
    with pytest.raises(SyncIntegrityError, match="checksum"):
        sync_and_compute(_copies(_replicas()), group)


def test_duplicate_payload_is_observable():
    replicas = _replicas()
    chaos = FaultInjectionGroup(
        _local_group(),
        faults=[FaultSpec(call=0, kind="duplicate", rank=1, src=0),
                FaultSpec(call=1, kind="duplicate", rank=1, src=0)],
    )
    group = ResilientGroup(chaos, timeout=2.0, retries=0, policy="raise")
    got = sync_and_compute(_copies(replicas), group)
    assert torch.equal(got, _merge_oracle(replicas, [0, 0, 2]).compute())


# ------------------------------------------------- determinism guarantees


@pytest.mark.parametrize(
    "name", ["MulticlassAccuracy", "Sum", "BinaryAUROC", "WindowedMeanSquaredError"]
)
def test_quorum_merge_deterministic_across_failing_collective(name):
    def synced_state(fault_call):
        chaos = FaultInjectionGroup(
            _local_group(), faults=[FaultSpec(call=fault_call, kind="drop", rank=1)]
        )
        group = ResilientGroup(chaos, timeout=2.0, retries=0, policy="quorum", backoff_base=0.0)
        synced = get_synced_metric(_copies(_replicas(name)), group)
        assert synced.sync_provenance.ranks == (0, 2)
        return synced

    _assert_same_state(synced_state(0), synced_state(1))


def test_backoff_schedule_is_seed_deterministic():
    def mk(seed):
        return ResilientGroup(
            _local_group(), policy="quorum", seed=seed,
            backoff_base=0.01, backoff_max=0.08, backoff_jitter=0.5,
        )

    a, b, c = mk(7), mk(7), mk(8)
    sched_a = [a._next_backoff(k) for k in range(1, 6)]
    assert sched_a == [b._next_backoff(k) for k in range(1, 6)]
    assert sched_a != [c._next_backoff(k) for k in range(1, 6)]
    for k, delay in enumerate(sched_a, start=1):
        base = min(0.01 * 2 ** (k - 1), 0.08)
        assert base <= delay <= base * 1.5


def test_fault_injection_group_is_deterministic_replay():
    def run():
        chaos = FaultInjectionGroup(
            _local_group(), faults=[FaultSpec(call=0, kind="transient")], dead_ranks={2}, seed=3
        )
        group = ResilientGroup(chaos, timeout=2.0, retries=2, policy="quorum", backoff_base=0.0,
                               seed=3)
        synced = get_synced_metric(_copies(_replicas()), group)
        health = group.health.as_dict()
        health.pop("last_good_sync")
        return synced.compute(), synced.sync_provenance, health, chaos.calls

    va, pa, ha, ca = run()
    vb, pb, hb, cb = run()
    assert torch.equal(va, vb) and pa == pb and ha == hb and ca == cb


# ----------------------------------------------------------- misc contracts


def test_partial_gather_propagates_without_resilience():
    chaos = FaultInjectionGroup(_local_group(), dead_ranks={1})
    with pytest.raises(PartialGatherError) as err:
        chaos.allgather_object(["a", "b", "c"])
    assert sorted(err.value.values) == [0, 2]
    assert err.value.values[2] == "c"


def test_on_failure_overrides_policy_per_call():
    replicas = _replicas()
    chaos = FaultInjectionGroup(_local_group(), dead_ranks={1})
    group = ResilientGroup(chaos, timeout=2.0, retries=0, policy="raise", backoff_base=0.0)
    with pytest.raises(SyncTimeoutError):
        sync_and_compute(_copies(replicas), group)
    synced = get_synced_metric(_copies(replicas), group, on_failure="quorum")
    assert synced.sync_provenance.ranks == (0, 2)
    assert group.health.degraded_syncs == 1


@pytest.mark.parametrize(
    "entry", ["sync_and_compute", "sync_and_compute_collection", "get_synced_metric",
              "get_synced_metric_collection", "get_synced_state_dict",
              "get_synced_state_dict_collection"],
)
def test_every_entry_point_takes_on_failure(entry):
    replicas = _replicas()
    collection = entry.endswith("_collection")
    arg = [{"m": m} for m in _copies(replicas)] if collection else _copies(replicas)
    chaos = FaultInjectionGroup(_local_group(), dead_ranks={1})
    with config.sync_resilience(timeout=2.0, retries=0):
        out = getattr(toolkit, entry)(arg, chaos, on_failure="quorum")
    oracle = _merge_oracle(replicas, [0, 2])
    if collection:
        out = out["m"]
    if entry.startswith("sync_and_compute"):
        assert torch.equal(out, oracle.compute())
    elif entry.startswith("get_synced_metric"):
        _assert_same_state(out, oracle)
        assert out.sync_provenance.ranks == (0, 2)
    else:
        assert out.keys() == oracle.state_dict().keys()
        assert all(torch.equal(out[k], v) for k, v in oracle.state_dict().items())


def test_config_knobs_wrap_default_path():
    replicas = _replicas()
    chaos = FaultInjectionGroup(_local_group(), dead_ranks={1})
    with config.sync_resilience(timeout=2.0, retries=0, degradation="quorum"):
        synced = get_synced_metric(_copies(replicas), chaos)
    assert synced.sync_provenance.ranks == (0, 2)
    _assert_same_state(synced, _merge_oracle(replicas, [0, 2]))


def test_resilient_group_rejects_bad_policy_and_quorum():
    with pytest.raises(ValueError, match="policy"):
        ResilientGroup(_local_group(), policy="retry-forever")
    with pytest.raises(ValueError, match="quorum"):
        ResilientGroup(_local_group(), quorum=0.0)


def test_zero_timeout_rejected_everywhere():
    for bad in (0.0, -1.0, float("nan")):
        with pytest.raises(ValueError, match="positive finite"):
            ResilientGroup(_local_group(), timeout=bad)
        with pytest.raises(ValueError, match="positive finite"):
            config.set_sync_timeout(bad)


def test_plain_allgather_refuses_partial_results():
    chaos = FaultInjectionGroup(_local_group(), dead_ranks={1})
    group = ResilientGroup(chaos, timeout=2.0, retries=0, policy="quorum", backoff_base=0.0)
    with pytest.raises(SyncTimeoutError, match="with_ranks"):
        group.allgather_object(["a", "b", "c"])
    values, ranks = group.allgather_object_with_ranks(["a", "b", "c"])
    assert ranks == [0, 2] and values == ["a", "c"]


def test_world_of_one_carries_full_provenance():
    m = _replicas(world=1)[0]
    synced = get_synced_metric(m, tdist.SingleProcessGroup())
    assert synced.sync_provenance == SyncProvenance((0,), 1, False, "raise")


def test_sync_resilience_context_does_not_leak_on_bad_knob():
    before = config.sync_timeout()
    with pytest.raises(ValueError, match="policy"):
        with config.sync_resilience(timeout=99.0, degradation="quorom"):
            pass
    assert config.sync_timeout() == before


def test_with_policy_keeps_shared_health_policy():
    group = ResilientGroup(_local_group(), policy="raise")
    sibling = group.with_policy("local")
    assert sibling.health is group.health
    assert sibling.policy == "local"
    assert group.health.policy == "raise"
    assert group.with_policy("raise") is group


def test_degrading_policy_arms_default_deadline():
    assert ResilientGroup(_local_group(), policy="quorum").timeout == DEFAULT_DEGRADING_TIMEOUT
    assert ResilientGroup(_local_group(), policy="raise").timeout is None
    assert DEFAULT_DEGRADING_TIMEOUT == jres.DEFAULT_DEGRADING_TIMEOUT


def test_late_completion_reclaims_worker_thread():
    replicas = _replicas()
    assert not resilience._still_in_flight(5.0)
    before = _worker_count()
    for _ in range(3):
        chaos = FaultInjectionGroup(
            _local_group(), faults=[FaultSpec(call=0, kind="delay", seconds=0.15, times=2)]
        )
        group = ResilientGroup(chaos, timeout=0.05, retries=2, policy="raise", backoff_base=0.1)
        sync_and_compute(_copies(replicas), group)
    assert not resilience._still_in_flight(5.0)
    time.sleep(0.1)  # stopped surplus workers leave their loops
    assert _worker_count() - before <= 1


def test_config_driven_health_reports_effective_policy():
    with config.sync_resilience(timeout=2.0, degradation="quorum"):
        sync_and_compute(_copies(_replicas()), _local_group())
    assert default_sync_health().policy == "quorum"


def test_config_driven_syncs_accumulate_default_health():
    before = default_sync_health().attempts
    with config.sync_resilience(timeout=2.0, degradation="quorum"):
        for _ in range(3):
            sync_and_compute(_copies(_replicas()), _local_group())
    assert default_sync_health().attempts - before >= 6


def test_retries_env_knob_alone_triggers_wrapping():
    with config.sync_resilience(retries=5):
        assert config.sync_resilience_configured()
    assert not config.sync_resilience_configured()


def test_bounded_call_deadline():
    assert bounded_call(lambda: 7, 1.0) == 7
    assert bounded_call(lambda: 8, None) == 8
    with pytest.raises(SyncTimeoutError, match="deadline"):
        bounded_call(lambda: time.sleep(0.2), 0.02)
    time.sleep(0.25)  # let the abandoned call finish


def test_synced_states_carry_participation_and_bytes():
    replicas = _replicas()
    payload = [{"m": m._sync_state_dict()} for m in replicas]
    group = ResilientGroup(FaultInjectionGroup(_local_group(), dead_ranks={2}), timeout=2.0,
                           policy="quorum")
    out = synclib.sync_states(payload, group)
    assert isinstance(out, synclib.SyncedStates)
    assert out.ranks == (0, 1) and out.world_size == WORLD and out.degraded
    assert len(out) == 2
    full = synclib.sync_states(payload, _local_group())
    assert full.ranks == (0, 1, 2) and not full.degraded
    assert full.sent_bytes == full.recv_bytes > 0
    assert out.recv_bytes == full.recv_bytes * 2 // 3


def test_sync_provenance_fields_and_defaults_match_jax():
    assert SyncProvenance._fields == jres.SyncProvenance._fields
    assert SyncProvenance._field_defaults == jres.SyncProvenance._field_defaults
    assert list(SyncHealth().as_dict()) == list(jres.SyncHealth().as_dict())
    assert SyncHealth().as_dict() == jres.SyncHealth().as_dict()


def test_reset_and_load_drop_stale_provenance():
    chaos = FaultInjectionGroup(_local_group(), dead_ranks={1})
    group = ResilientGroup(chaos, timeout=2.0, policy="quorum")
    synced = get_synced_metric(_copies(_replicas()), group)
    assert synced.sync_provenance.degraded
    synced.reset()
    assert not hasattr(synced, "sync_provenance")
    synced = get_synced_metric(_copies(_replicas()), group)
    synced.load_state_dict(_replicas()[0].state_dict())
    assert not hasattr(synced, "sync_provenance")


# ------------------------------------------------- the same faults, both packages


def _both(name, world, faults, dead, policy, **kw):
    """One scripted fault scenario run by each package on the same
    replicas: (provenance, health without timestamps, state, calls)."""
    out = []
    for P, tk, res, tu, grp in (
        (TM, toolkit, resilience, sys.modules["torcheval_tpu_torch.utils.test_utils"], _local_group),
        (JM, jtoolkit, jres, jtu, _jax_group),
    ):
        chaos = tu.FaultInjectionGroup(grp(world), [tu.FaultSpec(*f) for f in faults],
                                       dead_ranks=dead, seed=5)
        group = res.ResilientGroup(chaos, timeout=2.0, policy=policy, backoff_base=0.0, seed=5,
                                   **kw)
        try:
            synced = tk.get_synced_metric(_replicas(name, world, P), group)
            result = (tuple(synced.sync_provenance),
                      {k: _np(v) for k, v in synced.state_dict().items()})
        except Exception as e:  # noqa: BLE001 -- compared across packages
            result = (type(e).__name__, None)
        health = group.health.as_dict()
        health.pop("last_good_sync")
        out.append((result[0], health, result[1], chaos.calls))
    return out


SCENARIOS = {
    "dead_rank_quorum": ([], {3}, "quorum", {"quorum": 0.75}),
    "dead_rank_raise": ([], {3}, "raise", {"retries": 1}),
    "dead_rank_local": ([], {2}, "local", {}),
    "transient_then_dead": ([(0, "transient")], {1}, "quorum", {}),
    "drop_metadata": ([(0, "drop", 2, 5)], set(), "quorum", {"retries": 0}),
    "drop_payload": ([(1, "drop", 0)], set(), "quorum", {"retries": 0}),
    "transient_drop_recovers": ([(0, "drop", 2)], set(), "raise", {"retries": 2}),
    "corrupt_quorum": ([(1, "corrupt", 1)], set(), "quorum", {"retries": 0}),
    "corrupt_raise": ([(1, "corrupt", 3)], set(), "raise", {"retries": 0}),
    "duplicate": ([(0, "duplicate", 1, 1, 0.05, 0), (1, "duplicate", 1, 1, 0.05, 0)], set(),
                  "raise", {}),
    "quorum_not_met": ([], {1, 2, 3}, "quorum", {"quorum": 0.75, "retries": 0}),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("name", ["MulticlassAccuracy", "Sum"])
def test_same_faults_give_jax_provenance_health_and_values(scenario, name):
    faults, dead, policy, kw = SCENARIOS[scenario]
    (tp, th, ts, tc), (jp, jh, js, jc) = _both(name, 4, faults, dead, policy, **kw)
    assert tp == jp
    assert th == jh
    assert tc == jc
    assert (ts is None) == (js is None)
    if ts is not None:
        assert ts.keys() == js.keys()
        for k in ts:
            assert ts[k].dtype == js[k].dtype and np.array_equal(ts[k], js[k]), k


def _thread_world_reform(pkg):
    """Ranks 0-2 sync through a dead-rank-3 chaos wrapper under quorum
    with re-formation after 2; rank 3 joins the first two syncs."""
    P, tk, res, tu = pkg

    def body(g):
        metric = _feed(_make(P, "MulticlassAccuracy"), "MulticlassAccuracy", g.rank)
        if g.rank == 3:
            for _ in range(2):
                tk.get_synced_metric(metric, g)
            return None
        group = res.ResilientGroup(tu.FaultInjectionGroup(g, dead_ranks={3}), timeout=2.0,
                                   policy="quorum", reform_after=2)
        provs, values = [], []
        for _ in range(3):
            synced = tk.get_synced_metric(metric, group)
            provs.append(tuple(synced.sync_provenance))
            values.append(_np(synced.compute()))
        health = group.health.as_dict()
        health.pop("last_good_sync")
        return provs, health, values, tuple(group.ranks)

    return tu.ThreadWorld(4, timeout=10.0).run(body)


def test_thread_world_reformation_matches_jax():
    t = _thread_world_reform((TM, toolkit, resilience,
                              sys.modules["torcheval_tpu_torch.utils.test_utils"]))
    j = _thread_world_reform((JM, jtoolkit, jres, jtu))
    for r in range(3):
        tp, th, tv, tr = t[r]
        jp, jh, jv, jr = j[r]
        assert tp == jp and th == jh and tr == jr == (0, 1, 2)
        assert all(np.array_equal(a, b) for a, b in zip(tv, jv))
        assert tp[2][:4] == ((0, 1, 2), 3, False, "quorum") and tp[2][4]
        assert th["reforms"] == 1
    assert t[3] is None and j[3] is None


@pytest.mark.parametrize("seed", [0, 1, 7, 12345])
def test_backoff_delay_sequences_match_jax(seed):
    kw = dict(base=0.01, maximum=0.3, jitter=0.5)
    t_rng, j_rng = random.Random(seed), random.Random(seed)
    t = [backoff_delay(k, rng=t_rng, **kw) for k in range(1, 9)]
    j = [jres.backoff_delay(k, rng=j_rng, **kw) for k in range(1, 9)]
    assert t == j
    assert [backoff_delay(k) for k in range(6)] == [jres.backoff_delay(k) for k in range(6)]
    tg = ResilientGroup(_local_group(), policy="quorum", seed=seed)
    jg = jres.ResilientGroup(_jax_group(), policy="quorum", seed=seed)
    assert [tg._next_backoff(k) for k in range(1, 6)] == [jg._next_backoff(k) for k in range(1, 6)]


def test_quorum_count_matches_jax():
    for world in range(1, 9):
        for fraction in (0.01, 0.25, 0.5, 0.6, 0.75, 1.0):
            assert resilience.quorum_count(fraction, world) == jres.quorum_count(fraction, world)


# ------------------------------------------------------- collective budget


def _zoo(n, P=TM):
    kw = {"device": CPU} if P is TM else {}
    zoo = {
        "acc": P.MulticlassAccuracy(**kw), "f1": P.MulticlassF1Score(**kw),
        "auroc": P.BinaryAUROC(**kw), "auprc": P.BinaryAUPRC(**kw),
        "mse": P.MeanSquaredError(**kw), "r2": P.R2Score(**kw), "sum": P.Sum(**kw),
        "mean": P.Mean(**kw), "max": P.Max(**kw), "throughput": P.Throughput(**kw),
        "win_mse": P.WindowedMeanSquaredError(max_num_updates=4, **kw), "cat": P.Cat(**kw),
    }
    coll = dict(list(zoo.items())[:n])
    rng = np.random.default_rng(7)
    for name, m in coll.items():
        u = rng.uniform(size=8).astype(np.float32)
        if name in ("acc", "f1"):
            m.update(rng.uniform(size=(8, 4)).astype(np.float32), rng.integers(0, 4, 8))
        elif name in ("auroc", "auprc"):
            m.update(u, rng.integers(0, 2, 8).astype(np.float32))
        elif name in ("mse", "r2", "win_mse"):
            m.update(u, rng.uniform(size=8).astype(np.float32))
        elif name == "throughput":
            m.update(64, 2.0)
        else:
            m.update(u)
    return coll


@pytest.mark.parametrize("n_metrics", [1, 12])
def test_process_group_calls_constant_in_collection_size(n_metrics):
    coll = _zoo(n_metrics)
    group = _CountingGroup()
    synced = toolkit.sync_and_compute_collection(coll, group)
    assert group.object_gathers == 1 and group.array_gathers <= 1
    assert set(synced) == set(coll)
    assert torch.allclose(synced["acc"], coll["acc"].compute())


@pytest.mark.parametrize("n_metrics", [1, 12])
def test_resilient_wrapper_adds_zero_collectives(n_metrics):
    coll = _zoo(n_metrics)
    bare = _CountingGroup()
    want = toolkit.sync_and_compute_collection({k: copy.deepcopy(m) for k, m in coll.items()}, bare)
    counting = _CountingGroup()
    got = toolkit.sync_and_compute_collection(
        coll, ResilientGroup(counting, timeout=2.0, retries=2, policy="quorum"))
    assert counting.object_gathers == bare.object_gathers == 1
    assert counting.array_gathers == bare.array_gathers <= 1
    assert set(got) == set(want)
    assert torch.equal(got["acc"], want["acc"])


# ------------------------------------------------------------ config knobs


@pytest.mark.parametrize(
    "raw", ["", "  ", "2.5", "0", "-1", "nan", "inf", "abc", "7"],
)
def test_env_knob_parsing_matches_jax(raw, monkeypatch):
    monkeypatch.setenv("TEV_TEST_KNOB", raw)
    for fn, args in (("_env_timeout", ()), ("_env_int", (2, 0)), ("_env_int", (100, 1)),
                     ("_env_fraction", (0.5,))):
        got, want = [], []
        for mod, sink in ((config, got), (jconfig, want)):
            with _warnings_recorded() as rec:
                sink.append(getattr(mod, fn)("TEV_TEST_KNOB", *args))
            sink.append([str(w.message) for w in rec])
        assert got == want, (fn, raw)


def _warnings_recorded():
    import warnings

    class _Rec(warnings.catch_warnings):
        def __init__(self):
            super().__init__(record=True)

        def __enter__(self):
            rec = super().__enter__()
            warnings.simplefilter("always")
            return rec

    return _Rec()


def test_env_policy_parsing_matches_jax(monkeypatch):
    for raw in ("", "QUORUM", "local", "retry"):
        monkeypatch.setenv("TEV_TEST_POLICY", raw)
        with _warnings_recorded() as tr:
            t = config._env_choice("TEV_TEST_POLICY", "raise", config._SYNC_POLICIES)
        with _warnings_recorded() as jr:
            j = jconfig._env_choice("TEV_TEST_POLICY", "raise", jconfig._SYNC_POLICIES)
        assert t == j
        assert [str(w.message) for w in tr] == [str(w.message) for w in jr]


def test_knob_defaults_and_setters_match_jax():
    assert config._SYNC_POLICIES == jconfig._SYNC_POLICIES
    for getter in ("sync_timeout", "sync_retries", "sync_degradation", "sync_quorum",
                   "sync_reform_after", "snapshot_interval", "snapshot_retention",
                   "sync_resilience_configured"):
        assert getattr(config, getter)() == getattr(jconfig, getter)(), getter
    for setter, bad in (("set_sync_retries", -1), ("set_sync_quorum", 0.0),
                        ("set_sync_quorum", 1.5), ("set_sync_degradation", "retry"),
                        ("set_snapshot_interval", 0), ("set_snapshot_retention", 0),
                        ("set_sync_reform_after", -1)):
        with pytest.raises(ValueError) as te:
            getattr(config, setter)(bad)
        with pytest.raises(ValueError) as je:
            getattr(jconfig, setter)(bad)
        assert str(te.value) == str(je.value), setter


def test_knob_setters_round_trip_and_stay_apart_from_jax():
    try:
        config.set_snapshot_interval(7)
        config.set_snapshot_retention(3)
        config.set_sync_reform_after(2)
        assert (config.snapshot_interval(), config.snapshot_retention(),
                config.sync_reform_after()) == (7, 3, 2)
        assert jconfig.snapshot_interval() == 100 and jconfig.sync_reform_after() == 0
        with config.sync_resilience(timeout=1.5, retries=4, degradation="local", quorum=0.7):
            assert (config.sync_timeout(), config.sync_retries(), config.sync_degradation(),
                    config.sync_quorum()) == (1.5, 4, "local", 0.7)
            assert jconfig.sync_timeout() is None
        assert config.sync_timeout() is None
    finally:
        config.set_snapshot_interval(100)
        config.set_snapshot_retention(2)
        config.set_sync_reform_after(0)


# ------------------------------------------------------------- thread world


def test_thread_world_rendezvous_subgroups_and_deadline():
    world = ThreadWorld(3, timeout=1.0)

    def body(g):
        everyone = g.allgather_object(g.rank * 10)
        arrays = g.allgather_array(torch.tensor([g.rank]))
        sub = g.new_subgroup([0, 2])
        got = sub.allgather_object(g.rank) if sub.is_member else None
        return everyone, [a.tolist() for a in arrays], sub.rank, got

    out = world.run(body)
    assert out[0] == ([0, 10, 20], [[0], [1], [2]], 0, [0, 2])
    assert out[1][2] == -1 and out[1][3] is None
    with pytest.raises(TimeoutError, match="timed out"):
        ThreadWorld(2, timeout=0.2).run(lambda g: g.allgather_object(1) if g.rank else None)


# ------------------------------------------------------ the launch counter


def test_launch_counter_is_exact_under_thread_world():
    """K1's launch count is taken from every rank thread at once in the
    card's elastic phase: it must lose no increment (more rank threads
    than cores, the interpreter switching threads as often as it can)."""
    _kernels.reset_launch_counts()
    ranks, per_rank = 2 * (os.cpu_count() or 4), 5_000
    interval = sys.getswitchinterval()

    def body(g):
        for _ in range(per_rank):
            _kernels.count_launch("fused_auc_hist")

    try:
        sys.setswitchinterval(1e-6)
        ThreadWorld(ranks, timeout=30.0).run(body)
        assert _kernels.LAUNCHES["fused_auc_hist"] == ranks * per_rank
    finally:
        sys.setswitchinterval(interval)
        _kernels.reset_launch_counts()


# -------------------------------------------------- the schedule harness


def _bump_unguarded(box, n=5):
    for _ in range(n):
        tmp = box[0]
        box[0] = tmp + 1


def _ab(a, b):
    with a:
        with b:
            pass


def _ba(a, b):
    with b:
        with a:
            pass


def _find_seed(predicate, build, sweep=64):
    for seed in range(sweep):
        outcome = build(seed)
        if predicate(outcome):
            return seed, outcome
    pytest.fail(f"no seed in range({sweep}) produced the outcome")


def _race(seed):
    box = [0]
    sched = DeterministicScheduler(seed=seed, trace=[THIS])
    sched.spawn(_bump_unguarded, box)
    sched.spawn(_bump_unguarded, box)
    return sched.run(), box[0]


def test_same_seed_same_interleaving_same_outcome():
    r1, v1 = _race(11)
    r2, v2 = _race(11)
    assert r1.decisions == r2.decisions and v1 == v2
    assert r1.schedule_id != _race(12)[0].schedule_id


def test_schedule_id_round_trips():
    result = ScheduleResult(7, [0, 1, 1, 0], [None, None])
    assert result.schedule_id == "s7:0,1,1,0"
    assert ScheduleResult.parse_schedule_id(result.schedule_id) == [0, 1, 1, 0]


def test_seed_sweep_finds_lost_update_and_replay_reproduces_it():
    _, (result, value) = _find_seed(lambda o: o[1] < 10, _race)
    for _ in range(2):
        box = [0]
        DeterministicScheduler.replay(
            result.schedule_id,
            spawns=[(_bump_unguarded, (box,)), (_bump_unguarded, (box,))],
            trace=[THIS],
        )
        assert box[0] == value


def test_opposite_lock_order_deadlocks_with_stacks_and_replays():
    def run(seed):
        a, b = threading.Lock(), threading.Lock()
        sched = DeterministicScheduler(seed=seed, trace=[THIS], deadlock_timeout=0.4)
        sched.spawn(_ab, a, b, name="fence-then-ring")
        sched.spawn(_ba, a, b, name="ring-then-fence")
        try:
            sched.run()
            return None
        except DeadlockError as e:
            return e

    _, error = _find_seed(lambda e: e is not None, run)
    assert set(error.stacks) == {"fence-then-ring", "ring-then-fence"}
    a, b = threading.Lock(), threading.Lock()
    with pytest.raises(DeadlockError):
        DeterministicScheduler.replay(
            error.decisions, spawns=[(_ab, (a, b)), (_ba, (a, b))], trace=[THIS],
            deadlock_timeout=0.4,
        )


def _health_writer(health, n=4):
    for _ in range(n):
        with health._lock:
            health.attempts += 1
            health.retries += 1


def _health_reader(health, snapshots, n=6):
    for _ in range(n):
        snapshots.append(health.as_dict())


def test_sync_health_as_dict_is_torn_free():
    for seed in range(6):
        health = SyncHealth()
        snapshots = []
        sched = DeterministicScheduler(seed=seed, trace=[THIS, resilience])
        sched.spawn(_health_writer, health)
        sched.spawn(_health_reader, health, snapshots)
        result = sched.run()
        assert snapshots, result.schedule_id
        assert all(s["attempts"] == s["retries"] for s in snapshots), result.schedule_id


def test_schedule_harness_is_the_jax_packages_copy():
    from torcheval_tpu.utils.test_utils import schedule as jsched
    from torcheval_tpu_torch.utils.test_utils import schedule as tsched

    for name in ("DeterministicScheduler", "DeadlockError", "ScheduleResult"):
        assert [n for n in dir(getattr(tsched, name)) if not n.startswith("__")] == [
            n for n in dir(getattr(jsched, name)) if not n.startswith("__")]
    assert ScheduleResult.parse_schedule_id("s3:1,0") == jsched.ScheduleResult.parse_schedule_id(
        "s3:1,0")
