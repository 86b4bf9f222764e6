"""Distributed sync toolkit and collection helpers.

Counterpart of ``torcheval_tpu/metrics/toolkit.py``:
``sync_and_compute(_collection)``, ``get_synced_metric(_collection)`` and
``get_synced_state_dict(_collection)`` over local replicas or over
processes (each metric's ``_sync_state_dict()`` gathered through
``synclib.sync_states``, then merged rank by rank, in ascending rank
order, into clones; a process outside a subgroup gets its metrics back
untouched). Each takes ``on_failure=`` (``"raise"``, ``"local"`` or
``"quorum"``), which, like a configured ``config.sync_resilience``, wraps
the group in a ``resilience.ResilientGroup`` for the call; every synced
metric carries a ``sync_provenance`` naming the ranks that contributed.
Also ``update_collection`` (every plan built, and so validated,
before any runs; under shape bucketing the bucketed plans run as one
group -- one CUDA-graph replay on the card -- and the rest as another),
``classwise_converter``,
``clone_metric(s)``, ``reset_metrics`` and ``to_device``.

Observability (``torcheval_tpu_torch.obs``), recorder on only: a sync
runs inside a ``torcheval.sync`` span, records a ``SyncEvent`` mirroring
its provenance with the wire bytes and a cross-rank flow ordinal, and a
panel update is one span and one ``UpdateEvent`` (``fused`` = the metrics
its plans covered). ``sync_and_compute(_collection)`` feed host-scalar
values to an armed ``obs.monitor``; a tensor value is never read.

``adopt_synced`` drains a sharded metric or a keyed metric table
(``torcheval_tpu_torch.table``): it syncs, runs a table's drain-time
finalization on the merged state (``_pre_adopt_commit``: windowed-epoch
commit, the admission ladder's step, eviction), then loads the merged
state back, so each rank re-slices to its shard or owned keys with an
empty outbox. An admission-armed table's provenance carries its rung
(``_with_admission``).

The wire ladder (``torcheval_tpu_torch.wire``): each metric of a sync
rides the rung of its family (class name), ``wire.effective_rung``, and
its ``sync_provenance.wire_tier`` names the rung its payload actually rode
(``_with_wire_tier``). ``sync_and_compute(_collection)(plane=...)`` is the
non-blocking read of a ``syncplane.SyncPlane`` built over the same live
metrics: no collective, the freshest merged snapshot, its provenance
carrying the plane's staleness.
"""

from __future__ import annotations

import copy
import logging
import time
from typing import Any, Dict, Iterable, List, Optional, TypeVar, Union

import numpy as np
import torch

from torcheval_tpu_torch import config
from torcheval_tpu_torch.distributed import (
    LocalReplicaGroup,
    ProcessGroup,
    default_process_group,
)
from torcheval_tpu_torch.metrics import synclib
from torcheval_tpu_torch.metrics._bucket import apply_bucketing
from torcheval_tpu_torch.metrics._fuse import fused_accumulate_group, graphed_update_possible
from torcheval_tpu_torch.metrics.metric import Metric, TState, UpdatePlan
from torcheval_tpu_torch.obs import hist as _obs_hist
from torcheval_tpu_torch.obs import trace as _obs_trace
from torcheval_tpu_torch.obs.events import SyncEvent, UpdateEvent
from torcheval_tpu_torch.obs.recorder import RECORDER as _OBS
from torcheval_tpu_torch.resilience import (
    ResilientGroup,
    SyncProvenance,
    default_sync_health,
)
from torcheval_tpu_torch.utils.convert import numpy_to_tensor, shared_conversion_cache

_logger: logging.Logger = logging.getLogger(__name__)

__all__ = [
    "adopt_synced",
    "sync_and_compute",
    "sync_and_compute_collection",
    "get_synced_metric",
    "get_synced_metric_collection",
    "get_synced_state_dict",
    "get_synced_state_dict_collection",
    "classwise_converter",
    "clone_metric",
    "clone_metrics",
    "reset_metrics",
    "to_device",
    "update_collection",
]

TMetric = TypeVar("TMetric", bound=Metric)
MetricOrReplicas = Union[TMetric, List[TMetric]]


def _resolve_group(
    process_group: Optional[ProcessGroup], on_failure: Optional[str] = None
) -> ProcessGroup:
    """Pick the group and apply the resilience policy for this call.

    ``on_failure`` overrides the process-wide ``config.sync_degradation()``
    for one entry point; either source of a non-default policy (or a
    configured ``sync_timeout``) wraps the group in a ``ResilientGroup``.
    An explicitly passed ``ResilientGroup`` keeps its own knobs (and its
    accumulated ``SyncHealth``)."""
    group = process_group if process_group is not None else default_process_group()
    if isinstance(group, ResilientGroup):
        return group.with_policy(on_failure) if on_failure else group
    if on_failure is not None or config.sync_resilience_configured():
        # the wrapper lives only for this call: its counters accumulate
        # into the process-wide default_sync_health()
        wrapped = ResilientGroup(group, policy=on_failure, health=default_sync_health())
        # the process-wide record reports the policy now in effect
        wrapped.health.policy = wrapped.policy
        return wrapped
    return group


def _is_local_replica(group: ProcessGroup) -> bool:
    # dispatch on the innermost group: resilience and chaos wrappers must
    # not change which protocol (local replicas or processes) is spoken
    return isinstance(group.unwrap(), LocalReplicaGroup)


def _select_replicas(replicas, group: ProcessGroup, what: str) -> list:
    """The member replicas of a local-replica (sub)group: the full
    per-replica list, or for a subgroup also the parent world's list."""
    if not isinstance(replicas, (list, tuple)):
        raise TypeError(
            f"With a LocalReplicaGroup, pass the per-replica list of "
            f"{what} (one per device/replica)."
        )
    inner = group.unwrap()
    member_ranks, parent_world = inner._member_ranks, inner.parent_world
    if (
        member_ranks is not None
        and parent_world is not None
        and len(replicas) == parent_world
        and parent_world != group.world_size
    ):
        return [replicas[r] for r in member_ranks]
    if len(replicas) != group.world_size:
        raise ValueError(
            f"Got {len(replicas)} replicas for a group of world_size "
            f"{group.world_size}."
        )
    return list(replicas)


def sync_and_compute(
    metric: MetricOrReplicas,
    process_group: Optional[ProcessGroup] = None,
    on_failure: Optional[str] = None,
    *,
    plane: Optional[Any] = None,
) -> Any:
    """Sync state across ranks/replicas and compute on the merged state.

    ``on_failure`` (``"raise"`` | ``"local"`` | ``"quorum"``) overrides the
    configured degradation policy for this call: under a degrading policy
    a dead rank costs a bounded wait instead of a hang, and the value
    reflects the surviving ranks (``get_synced_metric(...).sync_provenance``
    names them).

    ``plane`` (a ``syncplane.SyncPlane`` built over this live metric)
    switches to the non-blocking bounded-staleness read: no collective;
    the freshest background-merged snapshot is computed, its
    ``sync_provenance`` carrying ``version``, ``rounds_behind`` and
    ``wall_age_seconds``. ``process_group`` and ``on_failure`` are
    ignored then: the plane's own communicator and policy govern its
    rounds."""
    if plane is not None:
        synced = plane.read_metric(metric)
        value = synced.compute()
        _maybe_observe_computed(f"computed/{type(synced).__name__}", value)
        return value
    synced = get_synced_metric(metric, process_group, on_failure=on_failure)
    value = synced.compute()
    _maybe_observe_computed(f"computed/{type(synced).__name__}", value)
    return value


def sync_and_compute_collection(
    metrics: Union[Dict[str, Metric], List[Dict[str, Metric]]],
    process_group: Optional[ProcessGroup] = None,
    on_failure: Optional[str] = None,
    *,
    plane: Optional[Any] = None,
) -> Dict[str, Any]:
    """Sync a ``{name: Metric}`` collection in one batched state exchange
    and compute every merged metric. ``on_failure``: see
    :func:`sync_and_compute`; ``plane``: the non-blocking read (the
    collection must be the one the plane was built over)."""
    if plane is not None:
        synced = plane.read_collection(metrics)
    else:
        synced = get_synced_metric_collection(metrics, process_group, on_failure=on_failure)
    values = {name: m.compute() for name, m in synced.items()}
    for name, value in values.items():
        _maybe_observe_computed(f"computed/{name}", value)
    return values


def _maybe_observe_computed(key: str, value: Any) -> None:
    """Feed a computed value into the armed SLO/anomaly monitor
    (``obs.monitor``) — ONLY when it is already a host scalar (a Python or
    numpy number). A tensor result is never read: on the card that would
    synchronize the stream; callers who want drift detection on tensor
    values call ``Monitor.observe`` with the value they read at their own
    latency budget.

    Series keys, as in the JAX package: collection syncs key by the
    caller's dict name (``computed/<name>``), single-metric
    ``sync_and_compute`` by the class name (``computed/<ClassName>``)."""
    from torcheval_tpu_torch.obs.monitor import current_monitor

    monitor = current_monitor()
    if monitor is None:
        return
    if isinstance(value, (bool, np.bool_)):
        value = int(value)
    if isinstance(value, (int, float, np.integer, np.floating)):
        monitor.observe(key, float(value))


def get_synced_metric(
    metric: MetricOrReplicas,
    process_group: Optional[ProcessGroup] = None,
    on_failure: Optional[str] = None,
) -> Metric:
    """Gather every rank's state and merge into a fresh metric, which
    carries ``sync_provenance``. ``on_failure``: see
    :func:`sync_and_compute`."""
    if isinstance(metric, (list, tuple)):
        wrapped: Any = [{"_metric": m} for m in metric]
    else:
        wrapped = {"_metric": metric}
    return get_synced_metric_collection(wrapped, process_group, on_failure=on_failure)[
        "_metric"
    ]


def _with_admission(provenance: SyncProvenance, metric: Metric) -> SyncProvenance:
    """Stamp a metric table's admission ladder onto its provenance.

    Per metric: one synced collection may mix armed tables with plain
    metrics. Unarmed metrics (and every non-table) keep the defaults
    (``sampled_fraction=1.0``, rung and epoch 0: full ingest)."""
    controller = getattr(metric, "_admission", None)
    if controller is None:
        return provenance
    rung = int(metric.admission_rung)
    return provenance._replace(
        sampled_fraction=float(controller.sampled_fraction(rung)),
        admission_rung=rung,
        admission_epoch=int(metric.admission_epoch),
    )


def _with_wire_tier(provenance: SyncProvenance, per_rank_states, name: str) -> SyncProvenance:
    """Stamp the rung this metric's payload actually rode
    (``synclib.SyncedStates.wire_tiers``). Per metric: one collection may
    mix int8-riding histograms with bit-exact counters."""
    tier = per_rank_states.wire_tiers.get(name, "exact")
    if tier == "exact":
        return provenance
    return provenance._replace(wire_tier=tier)


def _stamp(coll: Dict[str, Metric], provenance: SyncProvenance) -> Dict[str, Metric]:
    for m in coll.values():
        m.sync_provenance = _with_admission(provenance, m)
    return coll


def get_synced_metric_collection(
    metrics: Union[Dict[str, Metric], List[Dict[str, Metric]]],
    process_group: Optional[ProcessGroup] = None,
    on_failure: Optional[str] = None,
) -> Dict[str, Metric]:
    """Collection variant: every metric's states travel in one batched
    exchange ordered by ``synclib.metrics_traversal_order``; every rank
    merges the surviving ranks, folding them in ascending order (rank 0 +
    rank 1, then + rank 2, ...). Every merged metric carries
    ``sync_provenance``. A process outside the group's members, or a world
    of one, gets its collection back untouched (and stamped).
    ``on_failure``: see :func:`sync_and_compute`."""
    group = _resolve_group(process_group, on_failure)
    local = _is_local_replica(group)
    policy = getattr(group, "degradation_policy", "raise")
    if not group.is_member:
        coll = metrics if isinstance(metrics, dict) else metrics[0]
        return _stamp(coll, SyncProvenance((), group.world_size, False, policy))
    if not local and group.world_size == 1:
        _logger.warning(
            "World size is 1, and metric states are not synced; "
            "returning the input metric collection."
        )
        coll = metrics if isinstance(metrics, dict) else metrics[0]
        return _stamp(coll, SyncProvenance((group.rank,), 1, False, policy))

    if local:
        replicas = _select_replicas(metrics, group, "metric collections")
        payload: Any = [
            {name: m._sync_state_dict() for name, m in coll.items()} for coll in replicas
        ]
        template = replicas[0]
    else:
        payload = {name: m._sync_state_dict() for name, m in metrics.items()}
        template = metrics

    # causal tracing (recorder on only): the sync runs inside a span frame,
    # so resilience retries emitted underneath parent to it, and the
    # SyncEvent carries a cross-rank flow ordinal: the N-th sync issued
    # from this thread, the same sync on every rank by lockstep
    sync_t0, sync_flow, sync_on = 0.0, 0, _OBS.enabled
    if sync_on:
        sync_flow = _obs_trace.next_flow_id()
        sync_t0 = time.monotonic()
    # each metric rides the wire rung of its family (class name)
    families = {name: type(m).__name__ for name, m in template.items()}
    with _obs_trace.scope_or_null("torcheval.sync", sync_on) as sync_frame:
        per_rank_states = synclib.sync_states(payload, group, families=families)

    # the world size comes from the sync itself, not the group: a
    # re-formation during this sync takes effect from the next one
    ranks = tuple(per_rank_states.ranks)
    world = per_rank_states.world_size
    provenance = SyncProvenance(
        ranks=ranks,
        world_size=world,
        degraded=len(ranks) < world,
        policy=policy,
        reformed=bool(getattr(group, "was_reformed", False)),
    )
    if provenance.degraded:
        _logger.warning(
            "Metric sync degraded: merged state reflects ranks %s of %d "
            "(policy %r); result may be stale.",
            list(ranks), world, provenance.policy,
        )
    if _OBS.enabled and sync_frame is not None:
        # the SyncEvent mirrors the provenance field for field and adds
        # the wire bytes synclib read off its metadata exchange
        from torcheval_tpu_torch import wire as _wire

        sync_tier = max(per_rank_states.wire_tiers.values(), key=_wire.rung_index, default="exact")
        sync_seconds = time.monotonic() - sync_t0
        _obs_hist.observe("sync", sync_seconds)
        _OBS.record(
            SyncEvent(
                rank=group.rank,
                ranks=provenance.ranks,
                world_size=provenance.world_size,
                degraded=provenance.degraded,
                policy=provenance.policy,
                reformed=provenance.reformed,
                sent_bytes=per_rank_states.sent_bytes,
                recv_bytes=per_rank_states.recv_bytes,
                metrics=len(template),
                seconds=sync_seconds,
                wire_tier=sync_tier,
                flow=sync_flow,
                trace=sync_frame.trace_id,
                span=sync_frame.span_id,
                parent=sync_frame.parent_id,
            )
        )

    merged: Dict[str, Metric] = {}
    for name, base in template.items():
        rank_metrics: List[Metric] = []
        for rank_states in per_rank_states:
            clone = clone_metric(base)
            clone.load_state_dict(_restore_state_types(rank_states[name]), strict=False)
            rank_metrics.append(clone)
        target = rank_metrics[0].to(base.device)
        target.merge_state(rank_metrics[1:])
        target.sync_provenance = _with_wire_tier(
            _with_admission(provenance, target), per_rank_states, name
        )
        merged[name] = target
    return merged


def get_synced_state_dict(
    metric: MetricOrReplicas,
    process_group: Optional[ProcessGroup] = None,
    on_failure: Optional[str] = None,
) -> Dict[str, TState]:
    """The synced metric's ``state_dict()``: the same merged state on
    every rank, for a checkpoint. ``on_failure``: see
    :func:`sync_and_compute`."""
    group = _resolve_group(process_group, on_failure)
    if group.world_size == 1 and not _is_local_replica(group):
        m = metric if isinstance(metric, Metric) else metric[0]
        return m.state_dict()
    return get_synced_metric(metric, group).state_dict()


def get_synced_state_dict_collection(
    metrics: Union[Dict[str, Metric], List[Dict[str, Metric]]],
    process_group: Optional[ProcessGroup] = None,
    on_failure: Optional[str] = None,
) -> Dict[str, Dict[str, TState]]:
    """``{name: state_dict()}`` of the synced collection. ``on_failure``:
    see :func:`sync_and_compute`."""
    group = _resolve_group(process_group, on_failure)
    if group.world_size == 1 and not _is_local_replica(group):
        coll = metrics if isinstance(metrics, dict) else metrics[0]
        return {name: m.state_dict() for name, m in coll.items()}
    synced = get_synced_metric_collection(metrics, group)
    return {name: m.state_dict() for name, m in synced.items()}


def _restore_state_types(state_dict: Dict[str, Any]) -> Dict[str, TState]:
    """numpy payloads from the wire -> tensors; scalars stay native."""

    tensor = numpy_to_tensor

    restored: Dict[str, TState] = {}
    for name, value in state_dict.items():
        if isinstance(value, np.ndarray):
            restored[name] = tensor(value)
        elif isinstance(value, list):
            restored[name] = [tensor(v) for v in value]
        elif isinstance(value, dict):
            restored[name] = {k: tensor(v) for k, v in value.items()}
        else:
            restored[name] = value
    return restored


def _adoptable(m: Metric) -> bool:
    """Metrics whose merged state may be loaded back without counting it
    twice at the next sync: sharded ones (disjoint shards re-slice) and
    hash-partitioned tables (disjoint key sets re-slice). Replicated
    metrics are not: every rank would hold the global totals, and the
    next SUM sync would multiply them by the world size."""
    return bool(getattr(m, "_sharded_states", None)) or bool(
        getattr(m, "_hash_partitioned", False)
    )


def adopt_synced(
    metric: Union[MetricOrReplicas, Dict[str, Metric]],
    process_group: Optional[ProcessGroup] = None,
    on_failure: Optional[str] = None,
) -> Union[Metric, Dict[str, Metric]]:
    """Sync, then load the merged state back into the working metric: the
    drain point of a SHARDED metric or a keyed METRIC TABLE. Its outbox
    collects foreign contributions between syncs (O(batch x steps)
    entries), and a plain ``sync_and_compute`` leaves the working metric
    as it was; adopting re-slices the merged logical state to this rank's
    shard (or owned keys) and empties the outbox, so per-rank bytes return
    to ``size/world``. A table's drain-time finalization
    (``_pre_adopt_commit``: windowed-epoch commit, admission ladder step,
    TTL and occupancy eviction) runs on the merged state first, so those
    decisions are identical on every rank. Returns the synced (logical)
    metric, to ``compute()`` without a second exchange.

    Takes a metric, a replica list, or a ``{name: Metric}`` collection
    (drained in one exchange). Replicated members raise ``TypeError``:
    adopting their merged state would double-count it at the next sync."""
    if isinstance(metric, dict):
        for name, m in metric.items():
            if not _adoptable(m):
                raise TypeError(
                    f"adopt_synced requires sharded or table metrics; "
                    f"collection member {name!r} ({type(m).__name__}) is "
                    "replicated — adopting the merged state would "
                    "double-count it at the next sync (use "
                    "sync_and_compute / get_synced_metric instead)"
                )
        synced_coll = get_synced_metric_collection(metric, process_group, on_failure=on_failure)
        for name, synced in synced_coll.items():
            commit = getattr(synced, "_pre_adopt_commit", None)
            if commit is not None:
                commit()
            # read before loading: at world 1 `synced` IS the working
            # metric, and load_state_dict drops its provenance; the
            # admission fields are stamped after the commit, where the
            # ladder steps
            provenance = _with_admission(synced.sync_provenance, synced)
            metric[name].load_state_dict(synced.state_dict())
            metric[name].sync_provenance = provenance
        return synced_coll
    targets = metric if isinstance(metric, (list, tuple)) else [metric]
    for m in targets:
        if not _adoptable(m):
            raise TypeError(
                f"adopt_synced requires sharded or table metrics; "
                f"{type(m).__name__} is replicated — adopting the merged "
                "state would double-count it at the next sync (use "
                "sync_and_compute / get_synced_metric instead)"
            )
    synced = get_synced_metric(metric, process_group, on_failure=on_failure)
    commit = getattr(synced, "_pre_adopt_commit", None)
    if commit is not None:
        # a table's drain finalization on the MERGED state
        commit()
    payload = synced.state_dict()
    provenance = _with_admission(synced.sync_provenance, synced)
    for m in targets:
        m.load_state_dict(payload)
        m.sync_provenance = provenance
    return synced


def clone_metric(metric: TMetric) -> TMetric:
    """Deep copy."""
    return copy.deepcopy(metric)


def clone_metrics(metrics: List[TMetric]) -> List[TMetric]:
    return [clone_metric(m) for m in metrics]


def reset_metrics(metrics: Iterable[TMetric]) -> Iterable[TMetric]:
    """Reset a batch of metrics."""
    for metric in metrics:
        metric.reset()
    return metrics


def to_device(metrics: Iterable[TMetric], device: Any) -> Iterable[TMetric]:
    """Move a batch of metrics."""
    for metric in metrics:
        metric.to(device)
    return metrics


def update_collection(
    metrics: Union[Dict[str, Metric], Iterable[Metric]],
    *args: Any,
    **kwargs: Any,
) -> Union[Dict[str, Metric], Iterable[Metric]]:
    """Update every metric on the same batch.

    Every metric's update plan is built first -- each plan validates its
    inputs, and under shape bucketing is padded to its bucket, which
    checks its batch axes agree -- so a batch that any plan rejects raises
    before any metric has changed. Metrics without a plan then update
    themselves (a batch only their own ``update`` rejects can leave
    earlier ones of them updated), and the plans run.

    Under ``config.shape_bucketing()`` the plans rewritten for their
    bucket form one group and the rest another, as in the JAX package, so
    a metric without a masked kernel cannot make the bucketed group's
    shape follow the ragged batch. On CUDA, under donation, the bucketed
    group is ONE CUDA-graph replay per bucket; the other group runs
    eagerly. One pad is made per shared argument, and inside the call each
    input is converted once (``utils.convert.shared_conversion_cache``).
    Returns the input collection, updated in place.

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import MulticlassAccuracy, MulticlassF1Score
    >>> from torcheval_tpu_torch.metrics import toolkit
    >>> metrics = {"acc": MulticlassAccuracy(device="cpu"),
    ...            "f1": MulticlassF1Score(device="cpu")}
    >>> _ = toolkit.update_collection(
    ...     metrics, torch.tensor([[0.9, 0.1], [0.2, 0.8]]), torch.tensor([0, 1]))
    >>> metrics["acc"].compute()
    tensor(1.)
    """
    obs_on = _OBS.enabled
    t0 = time.monotonic() if obs_on else 0.0
    items = list(metrics.values() if isinstance(metrics, dict) else metrics)
    fallback: List[Metric] = []
    groups: Dict[bool, list] = {False: [], True: []}  # bucketed -> members
    pad_cache: dict = {}  # one pad per (tensor, bucket) across the panel
    # the whole panel is ONE span: fallback metrics' own update spans (and
    # any graph capture of the group) parent to it
    with _obs_trace.scope_or_null(
        "torcheval.update_collection", obs_on
    ) as panel_frame:
        with shared_conversion_cache():
            for metric in items:
                # validation, conversion and padding: a span a metric
                with _obs_trace.scope_or_null("torcheval.plan", obs_on, type(metric).__name__):
                    plan = metric._update_plan(*args, **kwargs)
                    if plan is None:
                        fallback.append(metric)
                        continue
                    bucketed = False
                    if isinstance(plan, UpdatePlan):
                        lazy = graphed_update_possible((metric,))
                        rewritten = apply_bucketing(plan, pad_cache, lazy=lazy)
                        bucketed = rewritten is not plan
                        plan = rewritten
                        kernel, names, dynamic, config = (
                            plan.kernel, plan.state_names, plan.dynamic, plan.config
                        )
                        transform, finalize = plan.transform, plan.finalize
                    else:
                        kernel, names, dynamic, *rest = plan
                        config = rest[0] if rest else ()
                        transform, finalize = False, None
                    states = tuple(getattr(metric, n) for n in names)
                    groups[bucketed].append(
                        (metric, names, finalize, (kernel, states, dynamic, config, transform))
                    )
            # fallbacks validate inside their own update: after every plan
            for metric in fallback:
                metric.update(*args, **kwargs)
        for bucketed, members in groups.items():
            if not members:
                continue
            group_metrics = [m for m, _, _, _ in members]
            donate = all(m._donation_active() for m in group_metrics)
            graph = bucketed and graphed_update_possible(group_metrics)
            new_states_group = fused_accumulate_group(
                [p for _, _, _, p in members], donate=donate, graph=graph,
                labels=[type(m).__name__ for m in group_metrics] if obs_on else None,
            )
            for (metric, names, finalize, _), new_states in zip(members, new_states_group):
                for name, value in zip(names, new_states):
                    setattr(metric, name, value)
                if finalize is not None:
                    finalize()
    if obs_on and panel_frame is not None:
        # ONE event for the whole panel (plan-fused metrics bypass their
        # own `update`, so this is their record; fallback metrics recorded
        # their own UpdateEvents above)
        t_mono, t_wall = time.monotonic(), time.time()
        seconds = t_mono - t0
        _obs_hist.observe("update/update_collection", seconds)
        _OBS.record(
            UpdateEvent(
                metric="update_collection",
                seconds=seconds,
                t_mono=t_mono,
                t_wall=t_wall,
                fused=len(items) - len(fallback),
                trace=panel_frame.trace_id,
                span=panel_frame.span_id,
                parent=panel_frame.parent_id,
            )
        )
    return metrics


def classwise_converter(
    input: torch.Tensor, name: str, labels: Optional[List[str]] = None
) -> Dict[str, torch.Tensor]:
    """A per-class vector as ``{f"{name}_{label}": value}`` (labels default
    to the class indices)."""
    if labels is None:
        return {f"{name}_{i}": val for i, val in enumerate(input)}
    if len(labels) != input.shape[0]:
        raise ValueError(
            f"Number of labels {len(labels)} must equal the number of classes "
            f"{input.shape[0]}."
        )
    return {f"{name}_{label}": val for label, val in zip(labels, input)}
