"""Collective lockstep checker: catch would-deadlock divergence before a run.

The counterpart of ``torcheval_tpu/analysis/lockstep.py``, with its public
names and rule ids. A multi-rank program deadlocks when any two ranks
disagree about the next collective. Each check extracts ordered
collective plans and diffs them:

- **rank-divergent programs** (:func:`verify_rank_lockstep`): run the
  per-rank program each member would run (builders are parameterized by
  rank -- the only way per-rank programs differ in this library) and diff
  the ordered plans. Where the JAX checker traces each rank, the port
  RUNS each rank's program on fake tensors (:func:`collective_plan`),
  its collectives on a :class:`PlanRecordingGroup` -- a ``ThreadWorld``-
  shaped rank view that loops back instead of communicating -- so one
  process plays every rank in turn. The plan holds the ``parallel/``
  axis collectives (``parallel.psum``, their ``_bwd`` forms under
  ``parallel.backward`` and its ``backward_plan``), the ``c10d`` ops and
  the ``ProcessGroup`` gathers, in program order.
- **data-dependent plans** (:func:`check_program_lockstep`): the JAX
  checker reads both arms of a ``lax.cond`` and the body of a ``while``
  from one jaxpr. Eager torch runs one branch, so a fixed program shows
  no branches to check. Here the SAME program runs for real on seeded
  variants of its inputs (and, through :func:`verify_rank_lockstep`,
  under every rank's view), and the plans are diffed: a plan that changes
  with the data is the hazard. Plans that differ in which ops they issue
  are ``branch-dependent-collective`` (error); plans that issue the same
  ops a data-dependent number of times are ``collective-in-loop``
  (warning).
- **eager call plans** (:func:`eager_sync_plan` +
  :func:`check_eager_lockstep`): the host-side ``synclib`` sync issues
  ``ProcessGroup`` collectives whose sequence depends on the metric
  states. Recording the plan against a :class:`PlanRecordingGroup` and
  diffing across ranks turns the in-flight-fence discipline into a
  checkable contract: same metrics, same op sequence, every rank.

All checks share :class:`~torcheval_tpu_torch.analysis.report.Finding`
records with the verifier and the lint, so one JSON report covers every
layer.
"""

from __future__ import annotations

import copy
import re
from dataclasses import dataclass
from typing import (
    Any,
    Callable,
    Dict,
    Iterable,
    List,
    Mapping,
    Optional,
    Sequence,
    Tuple,
)

import numpy as np
import torch

from torcheval_tpu_torch.analysis.program import (
    _Trace,
    _fake_mode,
    _fakeify,
    _map_tensors,
)
from torcheval_tpu_torch.analysis.report import Finding, Report, set_last_report
from torcheval_tpu_torch.utils.test_utils.thread_world import ThreadRankGroup

__all__ = [
    "CollectiveOp",
    "PlanRecordingGroup",
    "check_eager_lockstep",
    "check_program_lockstep",
    "collective_plan",
    "eager_sync_plan",
    "verify_rank_lockstep",
]


@dataclass(frozen=True)
class CollectiveOp:
    """One collective in a program's ordered plan.

    ``axes`` is empty here (a plan is one group's; the field keeps the
    JAX package's record); ``context`` is the input variant or rank view
    the plan came from;
    ``provenance`` is the source line that issued it. Two ops must agree
    on ``(name, axes)`` to rendezvous -- ``context`` and ``provenance``
    are diagnostics, excluded from equality checks.
    """

    name: str
    axes: Tuple[str, ...] = ()
    context: Tuple[str, ...] = ()
    provenance: str = ""

    @property
    def key(self) -> Tuple[str, Tuple[str, ...]]:
        return (self.name, self.axes)

    def format(self) -> str:
        where = f" under {'/'.join(self.context)}" if self.context else ""
        axes = f"[{','.join(self.axes)}]" if self.axes else ""
        return f"{self.name}{axes}{where} ({self.provenance})"


# ------------------------------------------------------ the recording group


class PlanRecordingGroup(ThreadRankGroup):
    """A loop-back rank view that RECORDS the collective call plan instead
    of communicating.

    It is a ``ProcessGroup`` (``synclib`` syncs through it) and a
    ``ThreadWorld`` rank view (``parallel/`` runs its axis collectives on
    it): every gather returns ``world_size`` copies of the local payload
    and every tensor exchange ``world_size`` references to the local
    tensors, so a protocol runs to completion in one thread -- a dry run
    of the plan, no wire, no peers. ``calls`` is the ordered op sequence
    (with LOCAL payload byte sizes for array gathers -- forensics only;
    :func:`check_eager_lockstep` strips them before diffing, since the
    padded protocol makes fill level rank-local): what a real group would
    be asked to perform *given this rank's local view*.
    """

    def __init__(self, world_size: int = 2, rank: int = 0):
        members = tuple(range(int(world_size)))
        super().__init__(None, int(rank), members, tag="plan")
        self.calls: List[str] = []

    def _exchange(self, payload: Any) -> List[Any]:
        return [copy.deepcopy(payload) for _ in range(self.world_size)]

    def allgather_object(self, obj: Any) -> List[Any]:
        self.calls.append("allgather_object")
        return self._exchange(obj)

    def allgather_array(self, x: Any) -> List[np.ndarray]:
        arr = np.asarray(x)
        self.calls.append(f"allgather_array[{arr.nbytes}B]")
        return [arr.copy() for _ in range(self.world_size)]

    def allgather_object_with_ranks(self, obj: Any):
        return self.allgather_object(obj), list(range(self.world_size))

    def allgather_array_with_ranks(self, x: Any):
        return self.allgather_array(x), list(range(self.world_size))

    def exchange_tensors(self, tensors: Any) -> List[Any]:
        self.calls.append("exchange_tensors")
        return [tensors for _ in range(self.world_size)]


# ----------------------------------------------------------- program plans


def _plan_of(rec, context: Tuple[str, ...] = ()) -> Tuple[CollectiveOp, ...]:
    return tuple(
        CollectiveOp(name=name, context=context, provenance=where)
        for name, where in rec.collectives
    )


def collective_plan(fn, *args: Any) -> Tuple[CollectiveOp, ...]:
    """The ordered collective plan of one program, run on fake tensors:
    nothing executes."""
    return _plan_and_trace(fn, args, True)[0]


def _plan_and_trace(fn, args, fake: bool, context=()):
    if fake:
        mode = _fake_mode()
        memo: Dict[int, Any] = {}
        args = tuple(_fakeify(mode, a, memo) for a in args)
        trace = _Trace(mode)
    else:
        trace = _Trace(None)
    with trace as rec:
        fn(*args)
    if trace.error is not None:
        raise RuntimeError(
            "the program's control flow reads its data, which fake tensors "
            "do not hold; check it with check_program_lockstep, which runs "
            "it for real"
        ) from trace.error
    return _plan_of(rec, context), rec


# ------------------------------------------------- single-program hazards


def _variant(args: Sequence[Any], seed: int) -> Tuple[Any, ...]:
    """``args`` with every tensor replaced by seeded data of its dtype,
    shape and device: floats standard normal, integers drawn over the
    original's range, bools fair coins."""
    gen = torch.Generator().manual_seed(seed)

    def leaf(t: torch.Tensor) -> torch.Tensor:
        if t.dtype == torch.bool:
            new = torch.rand(t.shape, generator=gen) < 0.5
        elif t.is_floating_point():
            new = torch.randn(t.shape, generator=gen, dtype=torch.float32)
        elif t.numel():
            lo, hi = int(t.min()), int(t.max())
            new = torch.randint(lo, hi + 1, t.shape, generator=gen)
        else:
            new = t.detach().cpu().clone()
        return new.to(dtype=t.dtype, device=t.device)

    return tuple(_map_tensors(a, leaf) for a in args)


def _hazards(
    plans: Mapping[str, Sequence[CollectiveOp]], label: str
) -> List[Finding]:
    """Findings for one program's plans over its input variants."""
    keys = {v: tuple(op.key for op in p) for v, p in plans.items()}
    if len(set(keys.values())) <= 1:
        return []
    detail = "; ".join(f"{v}={[k[0] for k in p]}" for v, p in keys.items())
    if len({frozenset(p) for p in keys.values()}) == 1:
        return [
            Finding(
                tool="lockstep",
                rule="collective-in-loop",
                path=label,
                severity="warning",
                message=(
                    "the program issues the same collectives a number of "
                    f"times that depends on its inputs ({detail}): the "
                    "trip count must be identical on every rank or the "
                    "collective counts diverge (would-deadlock)"
                ),
            )
        ]
    return [
        Finding(
            tool="lockstep",
            rule="branch-dependent-collective",
            path=label,
            message=(
                "the program's collective sequence depends on its inputs "
                f"({detail}): if the data ever differs across ranks, the "
                "ranks issue mismatched collectives and the job deadlocks"
            ),
        )
    ]


def check_program_lockstep(
    fn,
    *args: Any,
    name: Optional[str] = None,
    variants: int = 4,
    seed: int = 0,
) -> Report:
    """Data-dependent lockstep hazards of ONE program: it runs for real on
    ``args`` and on ``variants`` seeded variants of them, its collectives
    on whatever loop-back groups it was built over, and the plans are
    diffed (see the module docstring)."""
    label = name or getattr(fn, "__name__", None) or "<program>"
    report = Report(tool="lockstep")
    report.checked = 1
    plans = {"given": _plan_and_trace(fn, args, False, ("given",))[0]}
    for i in range(variants):
        tag = f"variant{i}"
        plans[tag] = _plan_and_trace(fn, _variant(args, seed + i), False, (tag,))[0]
    report.findings.extend(_hazards(plans, label))
    return set_last_report(report)


# --------------------------------------------------- per-rank program diff


def _diff_plans(
    report: Report,
    label: str,
    rule: str,
    plans: Mapping[Any, Sequence[Any]],
    fmt: Callable[[Any], str],
) -> None:
    """Diff every member's ordered plan against the first member's; emit
    one finding per diverging member at the first point of divergence."""
    members = sorted(plans)
    base_member = members[0]
    base = list(plans[base_member])
    for member in members[1:]:
        plan = list(plans[member])
        if [getattr(p, "key", p) for p in plan] == [
            getattr(p, "key", p) for p in base
        ]:
            continue
        i = 0
        while (
            i < len(base)
            and i < len(plan)
            and getattr(base[i], "key", base[i])
            == getattr(plan[i], "key", plan[i])
        ):
            i += 1
        mine = fmt(plan[i]) if i < len(plan) else "<no further collectives>"
        theirs = fmt(base[i]) if i < len(base) else "<no further collectives>"
        report.findings.append(
            Finding(
                tool="lockstep",
                rule=rule,
                path=label,
                message=(
                    f"rank {member} diverges from rank {base_member} at "
                    f"collective #{i}: {mine} vs {theirs} -- mismatched "
                    "collectives never rendezvous; the job deadlocks at "
                    f"this op (full plans: rank {base_member}="
                    f"{[fmt(p) for p in base]}, rank {member}="
                    f"{[fmt(p) for p in plan]})"
                ),
            )
        )


def verify_rank_lockstep(
    build_fn: Callable[[int], Callable],
    ranks: Iterable[int],
    *args: Any,
    name: Optional[str] = None,
    check_structure: bool = True,
) -> Report:
    """Run ``build_fn(rank)`` for every member and diff the ordered
    collective plans -- "every rank must issue the identical collective
    sequence".

    ``build_fn`` returns the program rank ``r`` would run, typically over
    a ``PlanRecordingGroup(world, r)``; the programs run on fake tensors
    (nothing executes). With ``check_structure`` each rank's program is also checked for
    data-dependent plans (:func:`check_program_lockstep`, which runs it
    for real on seeded variants of ``args``).
    """
    label = name or getattr(build_fn, "__name__", None) or "<program>"
    report = Report(tool="lockstep")
    plans: Dict[int, Tuple[CollectiveOp, ...]] = {}
    for rank in ranks:
        program = build_fn(rank)
        plans[rank] = _plan_and_trace(program, args, True, (f"rank {rank}",))[0]
        report.checked += 1
        if check_structure:
            sub = check_program_lockstep(
                program, *args, name=f"{label}[rank {rank}]", variants=2
            )
            report.findings.extend(sub.findings)
    if plans:
        _diff_plans(
            report,
            label,
            "rank-divergent-collective",
            plans,
            lambda op: op.format(),
        )
    return set_last_report(report)


# ------------------------------------------------------- eager call plans


def _array_leaves(value: Any):
    if isinstance(value, dict):
        for v in value.values():
            yield from _array_leaves(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _array_leaves(v)
    elif hasattr(value, "shape") and hasattr(value, "dtype"):
        yield value


def eager_sync_plan(
    metrics: Mapping[str, Any],
    *,
    world_size: int = 2,
    rank: int = 0,
) -> Tuple[str, ...]:
    """The ordered ``ProcessGroup`` op sequence one rank's eager
    collection sync would issue for ``metrics`` (``{name: Metric}``): one
    metadata ``allgather_object`` -- annotated with the state traversal
    order, the framing every rank must agree on -- plus one payload
    ``allgather_array`` when the collection carries any array-valued
    state.

    The protocol is dry-run to completion against a
    :class:`PlanRecordingGroup` (no wire, no peers; metrics are
    deep-copied so buffered states are not consumed), but the returned
    plan is computed from the collection's STRUCTURE, not this rank's
    fill level: the real protocol pads payloads to the global max and
    skips the payload gather only by *global* agreement, so local byte
    counts must not (and here cannot) fake a divergence. When EVERY
    rank's payload is empty the real protocol skips the payload gather
    by that same agreement while this plan still lists it: the skip is
    rank-uniform by construction, so it never deadlocks."""
    from torcheval_tpu_torch.metrics import synclib

    group = PlanRecordingGroup(world_size=world_size, rank=rank)
    states = {
        name: copy.deepcopy(m)._sync_state_dict()
        for name, m in metrics.items()
    }
    order = synclib.metrics_traversal_order(states)
    synclib.sync_states(states, group)  # dry run: the protocol must work
    plan = [
        "allgather_object["
        + ",".join(f"{m}.{s}" for m, s in order)
        + "]"
    ]
    if any(
        True
        for m, s in order
        for _ in _array_leaves(states[m][s])
    ):
        plan.append("allgather_array")
    return tuple(plan)


# PlanRecordingGroup annotates array gathers with the LOCAL payload byte
# count; the real protocol pads payloads to the global max, so local sizes
# are ignored when diffing.
_LOCAL_SIZE = re.compile(r"\[\d+B\]")


def check_eager_lockstep(
    plans: Mapping[int, Sequence[str]], *, name: str = "<eager sync>"
) -> Report:
    """Diff per-rank eager call plans (from :func:`eager_sync_plan`, or
    hand-recorded via :class:`PlanRecordingGroup`). Any divergence --
    op kind or payload framing -- is a would-deadlock finding: the ranks
    would issue mismatched (or differently-counted) group collectives.
    Local payload byte sizes (``allgather_array[40B]``) are stripped
    before comparison."""
    report = Report(tool="lockstep")
    report.checked = len(plans)
    if plans:
        _diff_plans(
            report,
            name,
            "eager-plan-divergence",
            {
                r: [_LOCAL_SIZE.sub("", str(op)) for op in p]
                for r, p in plans.items()
            },
            str,
        )
    return set_last_report(report)
