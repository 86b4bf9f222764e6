"""CLI: ``python -m torcheval_tpu_torch.analysis [paths...] [options]``.

The counterpart of ``python -m torcheval_tpu.analysis``, with the same
flags and exit codes. Runs the AST lint over the given paths (default: the
``torcheval_tpu_torch`` package) and prints a text or machine-readable
JSON report. Exit status 0 iff no unsuppressed error-severity finding
remains; a usage error (an unknown rule, nothing to check) exits 2.

``--programs`` additionally runs the program-verifier smoke: a
representative metric family per merge kind (sharded and routed cases
included), statically proving the no-host-escape / zero-collective /
donation-aliasing contracts on fake tensors on the metrics' own device,
then ten smokes over the port's subsystems (table ingest, admission,
flight lockstep, quality, federation lockstep, schedule lockstep, the
sync plane, the wire quantizer, failover and streaming). That arm
imports torch; the plain lint run never does.

``--concurrency`` additionally runs the concurrency verifier
(``analysis/locks.py`` + ``analysis/concurrency.py``): guarded-by lock
discipline, lock-order cycles, blocking-under-lock, and the cross-thread
collective hazard model. Stdlib-only, like the lint.
"""

from __future__ import annotations

import argparse
import os
import sys

from torcheval_tpu_torch.analysis.lint import RULES, lint_paths
from torcheval_tpu_torch.analysis.report import Finding, Report


def _default_paths() -> list:
    package_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return [package_dir]


def _smoke_device():
    """cuda when a CUDA device is available, else cpu. The smoke traces
    programs on fake tensors: the device picks which programs (a CUDA
    metric's update reaches the K1 op, a CPU metric's its plain
    version), not where anything computes."""
    import torch

    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _t(array):
    """A numpy array as a torch tensor (the metrics move it to their
    device)."""
    import torch

    return torch.from_numpy(array)


def _program_smoke(device=None) -> Report:
    """Static proof over one representative metric per family, sharded
    and routed cases included, plus the subsystem smokes, with metric
    state on ``device``."""
    import numpy as np

    from torcheval_tpu_torch import metrics as M
    from torcheval_tpu_torch.analysis.program import (
        verify_metric_compute,
        verify_metric_merge,
        verify_metric_update,
    )

    rng = np.random.default_rng(0)
    x2 = _t(rng.random((32, 5)).astype(np.float32))
    t1 = _t(rng.integers(0, 5, 32).astype(np.int32))
    xb = _t(rng.random(32).astype(np.float32))
    tb = _t(rng.integers(0, 2, 32).astype(np.float32))
    task_ids = _t(rng.integers(0, 8, 32).astype(np.int32))
    cases = [
        (M.MulticlassAccuracy(device=device), (x2, t1), {}),  # SUM counters
        (M.Mean(device=device), (xb,), {}),  # weighted-sum pair
        (M.MeanSquaredError(device=device), (xb, tb), {}),  # regression family
        # sharded state: the scatter-route update and the reassembling
        # merge verify like any family
        (
            M.MulticlassConfusionMatrix(8, shard=M.ShardContext(1, 4), device=device),
            (t1, t1),
            {},
        ),
        (
            M.HistogramBinnedAUROC(threshold=16, shard=M.ShardContext(0, 2), device=device),
            (xb, _t(rng.integers(0, 2, 32).astype(np.int32))),
            {},
        ),
        # the float-payload outbox lane: the routed row-form update
        (
            M.WeightedCalibration(num_tasks=8, shard=M.ShardContext(1, 4), device=device),
            (xb, tb, 1.0),
            {"task_ids": task_ids},
        ),
        # K1: one fused-AUC op an update
        (M.StreamingBinaryAUROC(device=device), (xb, tb), {}),
    ]
    combined = Report(tool="program")
    for metric, args, kwargs in cases:
        report = verify_metric_update(metric, *args, **kwargs)
        if report is not None:
            combined.extend(report)
        combined.extend(verify_metric_compute(metric))
        combined.extend(verify_metric_merge(metric))
    combined.extend(_table_ingest_smoke(device))
    combined.extend(_admission_smoke(device))
    combined.extend(_flight_lockstep_smoke(device))
    combined.extend(_quality_smoke(device))
    combined.extend(_federation_lockstep_smoke(device))
    combined.extend(_schedule_lockstep_smoke(device))
    combined.extend(_sync_plane_smoke(device))
    combined.extend(_wire_quant_smoke(device))
    combined.extend(_failover_smoke(device))
    combined.extend(_streaming_smoke(device))
    return combined


def _small_collection(device):
    """The two-metric collection the lockstep smokes sync."""
    import torch

    from torcheval_tpu_torch import metrics as M

    coll = {"acc": M.MulticlassAccuracy(device=device), "mean": M.Mean(device=device)}
    coll["acc"].update(torch.ones((4, 3)), torch.zeros((4,), dtype=torch.int32))
    coll["mean"].update(torch.ones((4,)))
    return coll


def _plan_changed(report: Report, tool: str, rule: str, path: str, message: str) -> None:
    report.findings.append(Finding(tool=tool, rule=rule, path=path, message=message))


def _sync_plane_smoke(device=None) -> Report:
    """The zero-stall sync plane must leave the SERVING path untouched.
    With a plane armed over the live collection (a snapshot published and
    merged), a watched metric's update program verifies exactly like the
    plane-off family, its update plan IS the baseline plan, and the
    blocking eager sync's ordered op plan is IDENTICAL to the plane-off
    plan on every rank (the plane's rounds run on their own
    communicator)."""
    import numpy as np

    from torcheval_tpu_torch import metrics as M
    from torcheval_tpu_torch.analysis.lockstep import (
        check_eager_lockstep,
        eager_sync_plan,
    )
    from torcheval_tpu_torch.analysis.program import (
        verify_metric_compute,
        verify_metric_update,
    )
    from torcheval_tpu_torch.syncplane import SyncPlane

    rng = np.random.default_rng(16)
    xb = _t(rng.random(32).astype(np.float32))
    x2 = _t(rng.random((32, 5)).astype(np.float32))
    t1 = _t(rng.integers(0, 5, 32).astype(np.int32))
    combined = Report(tool="program")
    coll = {"acc": M.MulticlassAccuracy(device=device), "mean": M.Mean(device=device)}
    coll["acc"].update(x2, t1)
    coll["mean"].update(xb)
    baseline_plan = coll["acc"]._update_plan(x2, t1)
    baseline_sync = {
        r: eager_sync_plan(coll, world_size=2, rank=r) for r in range(2)
    }
    with SyncPlane(coll) as plane:
        plane.publish()
        plane.run_round()
        report = verify_metric_update(coll["mean"], xb)
        if report is not None:
            combined.extend(report)
        combined.extend(verify_metric_compute(coll["mean"]))
        armed_plan = coll["acc"]._update_plan(x2, t1)
        armed_sync = {
            r: eager_sync_plan(coll, world_size=2, rank=r) for r in range(2)
        }
    combined.extend(
        check_eager_lockstep(
            {0: baseline_sync[0], 1: armed_sync[1]},
            name="<plane-armed sync plan>",
        )
    )
    combined.checked += 1
    if (
        armed_plan.kernel is not baseline_plan.kernel
        or armed_plan.state_names != baseline_plan.state_names
    ):
        _plan_changed(
            combined, "program", "plane-armed-update", "<plane-armed update plan>",
            "arming a SyncPlane rewrote the metric's update plan -- the "
            "plane observes published snapshots only and must never touch "
            "the serving-step program",
        )
    combined.checked += 1
    if baseline_sync != armed_sync:
        _plan_changed(
            combined, "lockstep", "eager-plan-divergence", "<plane-armed sync plan>",
            f"arming a SyncPlane changed the eager sync plan: {baseline_sync} "
            f"-> {armed_sync} -- plane rounds run on their own communicator "
            "and must never add, drop or reorder serving-group collectives",
        )
    return combined


class _Counting:
    """Collective counter around one ThreadWorld rank view."""

    def __init__(self, inner):
        self._inner = inner
        self.calls = 0

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def allgather_object(self, obj):
        self.calls += 1
        return self._inner.allgather_object(obj)

    def allgather_array(self, x):
        self.calls += 1
        return self._inner.allgather_array(x)


def _failover_smoke(device=None) -> Report:
    """The rank-loss autopilot must leave the serving program untouched.
    With a ``FailureDomain`` armed over a live collection, a detection
    poll and a status read issue ZERO collectives, the watched metric's
    update plan is the unarmed plan, and the SURVIVOR world's eager sync
    plan is identical to a fresh world of that size on every rank."""
    import numpy as np

    from torcheval_tpu_torch import metrics as M
    from torcheval_tpu_torch.analysis.lockstep import (
        check_eager_lockstep,
        eager_sync_plan,
    )
    from torcheval_tpu_torch.failover import FailureDomain
    from torcheval_tpu_torch.utils.test_utils import ThreadWorld

    rng = np.random.default_rng(19)
    x2 = _t(rng.random((32, 5)).astype(np.float32))
    t1 = _t(rng.integers(0, 5, 32).astype(np.int32))
    combined = Report(tool="program")
    coll = {"acc": M.MulticlassAccuracy(device=device), "mean": M.Mean(device=device)}
    coll["acc"].update(x2, t1)
    baseline_plan = coll["acc"]._update_plan(x2, t1)
    survivor_world = 3  # a 4-world that lost one rank
    fresh_sync = {
        r: eager_sync_plan(coll, world_size=survivor_world, rank=r)
        for r in range(survivor_world)
    }
    group = _Counting(ThreadWorld(1).views[0])
    with FailureDomain({"mean": M.Mean(device=device)}, group) as domain:
        domain.poll()
        domain.status()
        armed_plan = coll["acc"]._update_plan(x2, t1)
        armed_sync = {
            r: eager_sync_plan(coll, world_size=survivor_world, rank=r)
            for r in range(survivor_world)
        }
    combined.extend(
        check_eager_lockstep(
            {0: fresh_sync[0], 1: armed_sync[1], 2: armed_sync[2]},
            name="<survivor-world sync plan>",
        )
    )
    combined.checked += 1
    if group.calls != 0:
        _plan_changed(
            combined, "program", "failover-detect-collective", "<failover detection>",
            f"FailureDomain.poll()/status() issued {group.calls} collective(s) "
            "-- detection must read local signals only",
        )
    combined.checked += 1
    if (
        armed_plan.kernel is not baseline_plan.kernel
        or armed_plan.state_names != baseline_plan.state_names
    ):
        _plan_changed(
            combined, "program", "failover-armed-update", "<failover-armed update plan>",
            "arming a FailureDomain rewrote the metric's update plan",
        )
    combined.checked += 1
    if fresh_sync != armed_sync:
        _plan_changed(
            combined, "lockstep", "eager-plan-divergence", "<survivor-world sync plan>",
            f"a FailureDomain changed the survivor-world eager sync plan: "
            f"{fresh_sync} -> {armed_sync}",
        )
    return combined


def _world1_group():
    """A world-1 ``torch.distributed`` group for the in-step sync (the
    default group when one is up; else a gloo group over an in-process
    store, torn down by the caller) -> (group, created)."""
    import torch.distributed as dist

    if dist.is_initialized():
        return None, False
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    return None, True


def _wire_quant_smoke(device=None) -> Report:
    """The quantized in-step sync must cost nothing in program structure.
    At the int8 rung the EXTEND sync traces with no host escapes and its
    ordered collective sequence adds ZERO ops over the exact step (the
    quantized wire rides the SAME collectives as packed uint8 payloads),
    and the donated owner-partitioned carry at int8 stays donation-sound
    (the state written in place)."""
    import torch
    import torch.distributed as dist

    from torcheval_tpu_torch.analysis.program import (
        compare_collective_sequences,
        verify_program,
    )
    from torcheval_tpu_torch.metrics import ShardSpec
    from torcheval_tpu_torch.metrics.metric import MergeKind
    from torcheval_tpu_torch.metrics.sharded import sync_states_in_jit
    from torcheval_tpu_torch.utils.convert import canonicalize_device

    group, created = _world1_group()
    try:
        device = canonicalize_device(device)
        world = dist.get_world_size(group)
        specs = {"buf": MergeKind.EXTEND, "n": MergeKind.SUM}

        def extend_step(rung):
            def fn(xs, n):
                return sync_states_in_jit(
                    {"buf": xs, "n": n}, group, specs, compression=rung
                )

            fn.__name__ = f"extend_{rung}"
            return fn

        x = torch.zeros((world * 512,), dtype=torch.float32, device=device)
        n = torch.zeros((), dtype=torch.int32, device=device)
        combined = Report(tool="program")
        for rung in ("exact", "int8"):
            combined.extend(
                verify_program(
                    extend_step(rung), x, n,
                    name=f"wire_quant.extend[{rung}]", compile_hlo=False,
                )
            )
        combined.extend(
            compare_collective_sequences(
                extend_step("exact"), (x, n), extend_step("int8"), (x, n),
                name="wire_quant.extend.zero-added-collectives", allow_added=0,
            )
        )

        def carry(state, delta):
            owned = sync_states_in_jit(
                {"hist": delta[0]},
                group,
                {"hist": MergeKind.SUM},
                compression="int8",
                shard_specs={"hist": ShardSpec(axis=0)},
            )
            return state.add_(owned["hist"])

        combined.extend(
            verify_program(
                carry,
                torch.zeros((1024 // world,), dtype=torch.float32, device=device),
                torch.zeros((world, 1024), dtype=torch.float32, device=device),
                name="wire_quant.reduce_scatter[int8].donated",
                donate_argnums=(0,),
                expect_hlo_collectives=None,
            )
        )
        return combined
    finally:
        if created:
            dist.destroy_process_group()


def _schedule_lockstep_smoke(device=None) -> Report:
    """The deterministic-schedule harness (``utils/test_utils/schedule.py``)
    must be instrumentation, not behaviour: an eager sync plan extracted
    while its ``sys.settrace`` scheduler drives the sync protocol is
    IDENTICAL to the uninstrumented plan on every rank."""
    from torcheval_tpu_torch.analysis.lockstep import (
        check_eager_lockstep,
        eager_sync_plan,
    )
    from torcheval_tpu_torch.metrics import synclib
    from torcheval_tpu_torch.utils.test_utils.schedule import (
        DeterministicScheduler,
    )

    coll = _small_collection(device)
    baseline = {
        r: eager_sync_plan(coll, world_size=2, rank=r) for r in range(2)
    }
    instrumented = {}
    for rank in range(2):
        sched = DeterministicScheduler(seed=rank, trace=[synclib])
        sched.spawn(eager_sync_plan, coll, world_size=2, rank=rank)
        instrumented[rank] = sched.run().values[0]
    report = check_eager_lockstep(
        {0: baseline[0], 1: instrumented[1]},
        name="<schedule-instrumented sync plan>",
    )
    report.checked += 1
    if baseline != instrumented:
        _plan_changed(
            report, "lockstep", "eager-plan-divergence",
            "<schedule-instrumented sync plan>",
            "driving the sync protocol under the deterministic-schedule "
            f"harness changed the plan: {baseline} -> {instrumented}",
        )
    return report


def _quality_smoke(device=None) -> Report:
    """A ``quality.watch_inputs``-armed update -- the watched metric's own
    kernel plus the sketch folds run as ONE program -- must verify exactly
    like the unwatched family, for the plain AND the bucketed masked
    program. Also the off-gate: with ``QUALITY.enabled`` False the watched
    plan IS the baseline plan."""
    import numpy as np

    from torcheval_tpu_torch import metrics as M
    from torcheval_tpu_torch.analysis.program import (
        verify_metric_compute,
        verify_metric_update,
    )
    from torcheval_tpu_torch.obs import quality

    rng = np.random.default_rng(13)
    x2 = _t(rng.random((32, 5)).astype(np.float32))
    t1 = _t(rng.integers(0, 5, 32).astype(np.int32))
    combined = Report(tool="program")
    metric = M.MulticlassAccuracy(device=device)
    baseline = metric._update_plan(x2, t1)
    quality.watch_inputs(metric)
    try:
        report = verify_metric_update(metric, x2, t1)
        if report is not None:
            combined.extend(report)
        combined.extend(verify_metric_compute(metric))
        prev = quality.QUALITY.enabled
        quality.QUALITY.enabled = False
        try:
            paused = metric._update_plan(x2, t1)
        finally:
            quality.QUALITY.enabled = prev
    finally:
        for watch in quality.active_watches():
            watch.close()
    combined.checked += 1
    if (
        paused.kernel is not baseline.kernel
        or paused.state_names != baseline.state_names
    ):
        _plan_changed(
            combined, "program", "quality-off-gate", "<watched update plan>",
            "with QUALITY.enabled False a watched metric's update plan must "
            "be the baseline plan, got a rewritten plan",
        )
    return combined


def _table_ingest_smoke(device=None) -> Report:
    """The keyed metric table's fused ingest program: transfer-free once
    the host intake has admitted the keys, collective-free and
    donation-sound, for a plain and a windowed family, on the warmed
    steady state."""
    import numpy as np

    from torcheval_tpu_torch.analysis.program import (
        verify_metric_compute,
        verify_metric_update,
    )
    from torcheval_tpu_torch.metrics import ShardContext
    from torcheval_tpu_torch.table import MetricTable

    rng = np.random.default_rng(12)
    keys = rng.integers(0, 64, 32)
    combined = Report(tool="program")
    for family, args in (
        ("ctr", (rng.integers(0, 2, 32).astype(np.float32),)),
        (
            "windowed_ne",
            (
                rng.uniform(0.05, 0.95, 32).astype(np.float32),
                rng.integers(0, 2, 32).astype(np.float32),
            ),
        ),
    ):
        table = MetricTable(family, shard=ShardContext(1, 4), device=device)
        table.ingest(keys, *args)  # warm the host intake
        report = verify_metric_update(table, keys, *args)
        if report is not None:
            combined.extend(report)
        combined.extend(verify_metric_compute(table))
    return combined


def _streaming_smoke(device=None) -> Report:
    """The streaming decode-step ingest: a warmed ``StreamTable`` over the
    logprob + token-edit + ngram families verifies like any table, on the
    plain program and its masked bucketed twin; the standalone streaming
    metrics' sequential-fold updates verify the same way."""
    import numpy as np

    from torcheval_tpu_torch.analysis.program import (
        verify_metric_compute,
        verify_metric_update,
    )
    from torcheval_tpu_torch.metrics import ShardContext
    from torcheval_tpu_torch.streaming import (
        StreamingNgramOverlap,
        StreamingPerplexity,
        StreamingTokenEditStats,
    )
    from torcheval_tpu_torch.table import StreamTable
    from torcheval_tpu_torch.table.streaming import _ngram_fields

    rng = np.random.default_rng(20)
    ids = rng.integers(0, 64, 32)
    lp = (-rng.uniform(0.05, 2.0, 32)).astype(np.float32)
    hyp = rng.integers(0, 30, 32).astype(np.int32)
    ref = rng.integers(0, 30, 32).astype(np.int32)
    combined = Report(tool="program")

    table = StreamTable(
        ("logprob", "token_edit", "ngram"), n_gram=4, shard=ShardContext(1, 4),
        device=device,
    )
    table.ingest(ids, step_tokens=hyp, logprobs=lp, ref_tokens=ref)
    payload = np.zeros((32, len(_ngram_fields(4))), np.float32)
    report = verify_metric_update(
        table,
        ids,
        logprob={"logprobs": lp},
        token_edit={"step_tokens": hyp, "ref_tokens": ref},
        ngram={"payload": payload},
    )
    if report is not None:
        combined.extend(report)
    combined.extend(verify_metric_compute(table))

    for metric, args in (
        (StreamingPerplexity(device=device), (lp,)),
        (StreamingTokenEditStats(device=device), (hyp, ref)),
        (StreamingNgramOverlap(n_gram=4, device=device), (hyp, ref)),
    ):
        metric.update(*args)
        report = verify_metric_update(metric, *args)
        if report is not None:
            combined.extend(report)
        combined.extend(verify_metric_compute(metric))
    return combined


def _admission_smoke(device=None) -> Report:
    """Admission-armed one-intake panel ingest: with an
    ``AdmissionController`` armed over a 4-family ``TablePanel`` the
    warmed fused ingest verifies like the unarmed table (the gate is
    host-side; the only traced addition is the per-row ``inv_weight``
    scale). Also the off-gate: a disarmed table's update plan IS the
    baseline plan."""
    import numpy as np

    from torcheval_tpu_torch.analysis.program import (
        verify_metric_compute,
        verify_metric_update,
    )
    from torcheval_tpu_torch.metrics import ShardContext
    from torcheval_tpu_torch.table import (
        AdmissionController,
        MetricTable,
        ServingBudget,
        TablePanel,
    )

    rng = np.random.default_rng(17)
    keys = rng.integers(0, 64, 32)
    clicks = rng.integers(0, 2, 32).astype(np.float32)
    preds = rng.uniform(0.05, 0.95, 32).astype(np.float32)
    targets = rng.integers(0, 2, 32).astype(np.float32)
    combined = Report(tool="program")

    panel = TablePanel(
        ["ctr", "weighted_calibration", "ne", ("hits", "hit_rate")],
        shard=ShardContext(1, 4),
        admission=AdmissionController(ServingBudget(max_keys=256), sample_p=0.5),
        device=device,
    )
    scores = rng.random((32, 8)).astype(np.float32)
    ranks = rng.integers(0, 8, 32)
    bundle = dict(
        ctr={"clicks": clicks},
        weighted_calibration={"preds": preds, "targets": targets},
        ne={"preds": preds, "targets": targets},
        hits={"scores": scores, "targets": ranks},
    )
    panel.ingest(keys, **bundle)  # warm the host intake
    report = verify_metric_update(panel, keys, **bundle)
    if report is not None:
        combined.extend(report)
    combined.extend(verify_metric_compute(panel))

    baseline = MetricTable("ctr", shard=ShardContext(1, 4), device=device)
    toggled = MetricTable(
        "ctr",
        shard=ShardContext(1, 4),
        admission=AdmissionController(ServingBudget(max_keys=256)),
        device=device,
    )
    toggled.disarm_admission()
    base_plan = baseline._update_plan(keys, clicks)
    off_plan = toggled._update_plan(keys, clicks)
    combined.checked += 1
    if (
        off_plan.kernel is not base_plan.kernel
        or len(off_plan.dynamic) != len(base_plan.dynamic)
        or off_plan.batch_axes != base_plan.batch_axes
    ):
        _plan_changed(
            combined, "program", "admission-off-gate", "<table update plan>",
            "a disarmed table's update plan must be the baseline plan (same "
            "cached ingest kernel, no inv_weight operand), got a rewritten plan",
        )
    return combined


def _flight_lockstep_smoke(device=None) -> Report:
    """The live-diagnosis layer must be telemetry, not behaviour: with the
    flight recorder and the SLO monitor armed, the eager sync's ordered op
    plan is IDENTICAL to the diagnosis-off plan on every rank."""
    from torcheval_tpu_torch.analysis.lockstep import (
        check_eager_lockstep,
        eager_sync_plan,
    )
    from torcheval_tpu_torch.obs.flight import FLIGHT
    from torcheval_tpu_torch.obs.monitor import arm_monitor, disarm_monitor

    coll = _small_collection(device)
    baseline = {
        r: eager_sync_plan(coll, world_size=2, rank=r) for r in range(2)
    }
    FLIGHT.enable("analysis")
    arm_monitor()
    try:
        armed = {
            r: eager_sync_plan(coll, world_size=2, rank=r) for r in range(2)
        }
    finally:
        disarm_monitor()
        FLIGHT.disable("analysis")
    report = check_eager_lockstep(
        {0: baseline[0], 1: armed[1]}, name="<flight+monitor sync plan>"
    )
    report.checked += 1
    if baseline != armed:
        _plan_changed(
            report, "lockstep", "eager-plan-divergence", "<flight+monitor sync plan>",
            "arming the flight recorder / SLO monitor changed the eager sync "
            f"plan: {baseline} -> {armed}",
        )
    return report


def _federation_lockstep_smoke(device=None) -> Report:
    """Arming a cross-region federation must not change the INTRA-REGION
    sync protocol: with a federation armed, the eager sync's ordered op
    plan is IDENTICAL to the federation-off plan on every rank."""
    from torcheval_tpu_torch.analysis.lockstep import (
        check_eager_lockstep,
        eager_sync_plan,
    )
    from torcheval_tpu_torch.federation import Federation, InProcessLinkBus
    from torcheval_tpu_torch.utils.test_utils import ThreadWorld

    coll = _small_collection(device)
    baseline = {
        r: eager_sync_plan(coll, world_size=2, rank=r) for r in range(2)
    }
    fed = Federation(
        ThreadWorld(2).views[0],
        [("us", (0,)), ("eu", (1,))],
        transport=InProcessLinkBus(),
    )
    try:
        armed = {
            r: eager_sync_plan(coll, world_size=2, rank=r) for r in range(2)
        }
    finally:
        fed.close()
    report = check_eager_lockstep(
        {0: baseline[0], 1: armed[1]}, name="<federation-armed sync plan>"
    )
    report.checked += 1
    if baseline != armed:
        _plan_changed(
            report, "lockstep", "eager-plan-divergence", "<federation-armed sync plan>",
            f"arming a Federation changed the eager sync plan: {baseline} -> "
            f"{armed}",
        )
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m torcheval_tpu_torch.analysis",
        description="torcheval_tpu_torch static analysis (lint / verifier)",
    )
    parser.add_argument(
        "paths",
        nargs="*",
        help="files or directories to lint (default: the torcheval_tpu_torch "
        "package)",
    )
    parser.add_argument(
        "--report",
        choices=("text", "json"),
        default="text",
        help="output format (json is the machine-readable artifact)",
    )
    parser.add_argument(
        "--output",
        default=None,
        metavar="FILE",
        help="also write the report to FILE",
    )
    parser.add_argument(
        "--rules",
        default=None,
        metavar="ID[,ID...]",
        help="run only these lint rules",
    )
    parser.add_argument(
        "--list-rules",
        action="store_true",
        help="print the lint rule catalogue and exit",
    )
    parser.add_argument(
        "--programs",
        action="store_true",
        help="also run the program-verifier smoke (imports torch)",
    )
    parser.add_argument(
        "--no-lint",
        action="store_true",
        help="skip the AST lint (with --programs: verifier only)",
    )
    parser.add_argument(
        "--concurrency",
        action="store_true",
        help="also run the concurrency verifier (lock discipline, "
        "lock-order cycles, blocking-under-lock, cross-thread collective "
        "hazards; stdlib-only, no torch)",
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule_id in sorted(RULES):
            print(f"{rule_id}: {RULES[rule_id].description}")
        return 0

    combined = Report(tool="analysis")
    if not args.no_lint:
        rules = None
        if args.rules:
            rules = [r.strip() for r in args.rules.split(",") if r.strip()]
        try:
            lint_report = lint_paths(args.paths or _default_paths(), rules=rules)
        except ValueError as exc:  # unknown rule ids (lint._select_rules)
            parser.error(str(exc))
        if lint_report.checked == 0:
            parser.error(
                "no Python files found under the given paths -- "
                "nothing was linted"
            )
        combined.extend(lint_report)
    if args.concurrency:
        from torcheval_tpu_torch.analysis.concurrency import check_concurrency

        concurrency_report = check_concurrency(args.paths or _default_paths())
        if concurrency_report.checked == 0:
            parser.error(
                "no Python files found under the given paths -- "
                "nothing was swept for concurrency"
            )
        combined.extend(concurrency_report)
    if args.programs:
        combined.extend(_program_smoke(_smoke_device()))

    if combined.checked == 0:
        # --no-lint without --programs/--concurrency disables every arm
        parser.error(
            "nothing was checked -- --no-lint requires --programs or "
            "--concurrency"
        )

    text = combined.to_json() if args.report == "json" else combined.format_text()
    print(text)
    if args.output:
        with open(args.output, "w", encoding="utf-8") as f:
            f.write(text + "\n")
    return 0 if combined.ok else 1


if __name__ == "__main__":
    sys.exit(main())
