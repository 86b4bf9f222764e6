"""Metric-program verifier: static checks at the torch dispatch layer.

The counterpart of ``torcheval_tpu/analysis/program.py``, with its public
names, rule ids and report schema. The JAX verifier reads a jaxpr and the
optimized HLO; eager torch has neither. Here a program is RUN ON FAKE
TENSORS (``FakeTensorMode``, on the metric's own device: fake ``cuda``
tensors for a metric on a card) under a ``TorchDispatchMode`` that records
every op it issues -- its name, its dtypes and its Python provenance (the
file and line of the innermost caller outside torch and this package, the
counterpart of ``_eqn_provenance``). Nothing executes: a fake tensor has
no storage, so no kernel runs and nothing reads back. What one step
issues is then checked WITHOUT executing a step:

- **no host escapes** (``host-callback``): ``aten._local_scalar_dense``
  (``.item()``, ``bool(t)``, ``float(t)``), a copy between the host and an
  accelerator either way (a read back, or an upload of host data such as
  ``torch.tensor(n, device="cuda")``, which waits on a pageable copy),
  ``.numpy()`` of a tensor, and any op fake mode refuses because its
  output depends on the data (``DataDependentOutputException`` / ``DynamicOutputShapeException``:
  ``bincount``, ``nonzero``, ``unique``, ``masked_select``). On CUDA each
  of these reads device data back to the host. A refused op ends the trace
  there: the report covers the program up to it.
- **collective census** (``collective-census``): the ordered collectives
  -- ``c10d`` / ``_c10d_functional`` ops seen by the dispatch mode, the
  ``parallel/`` axis collectives (``parallel._axis``'s census, by name),
  and the port ``ProcessGroup``'s ``allgather_*`` calls -- against a
  declared expectation (``expect_collectives=0`` for a local update).
  ``hlo_collectives`` is the c10d-op view alone (the ops a
  ``torch.distributed`` backend would run); ``expect_hlo_collectives``
  pins it. No HLO exists, so ``compile_hlo`` keeps only its role of
  switching the donation check on.
- **donation soundness** (``donated-not-aliased``): under donation each
  new state must have the live state's dtype and shape, so ``_fuse``
  writes it in place (``metrics/_fuse.py``: "XLA aliases only matching
  buffers too" is the contract); a donated buffer with no such output is
  an error (a 0-d scalar a warning). At the call layer
  (:func:`check_donation_aliasing`) no storage may be donated twice or
  also passed un-donated (``donated-twice``, ``donated-also-read``),
  keyed by ``untyped_storage().data_ptr()``.
- **dtype safety** (``dtype-64bit``, ``dtype-narrowing``): float64
  anywhere, and int64 in a STATE or a program output. Torch makes int64
  index tensors (``argmax``, ``arange``, scatter indices) where JAX with
  x64 off makes int32, so int64 intermediates are not flagged. Narrowing
  is a float64->float32 copy anywhere, or an int64->int32 copy of a
  STATE (the wire payload), that did not go through
  ``utils.convert.narrow_64``: an int64 input or index cast to int32 in a
  kernel is what the reference's x64-off boundary does to it.

The runtime pins (``assert_update_transfer_free``,
``assert_donated_update_in_place``) run a real update: on CUDA under
``torch.cuda.set_sync_debug_mode("error")`` with state pointers held
across the update, on the CPU under the dispatch recorder's host-escape
rule.
"""

from __future__ import annotations

import copy
import os
import sys
from dataclasses import dataclass
from typing import (
    Any,
    Dict,
    Iterator,
    List,
    Optional,
    Sequence,
    Tuple,
    Union,
)

import torch
from torch._subclasses.fake_tensor import (
    DataDependentOutputException,
    DynamicOutputShapeException,
    FakeTensorMode,
)
from torch.utils._python_dispatch import TorchDispatchMode

from torcheval_tpu_torch.analysis.report import Finding, Report, set_last_report
from torcheval_tpu_torch.distributed import (
    add_gather_listener,
    inside_gather,
    remove_gather_listener,
)

__all__ = [
    "ProgramReport",
    "assert_donated_update_in_place",
    "assert_update_transfer_free",
    "check_donation_aliasing",
    "compare_collective_sequences",
    "verify_metric_compute",
    "verify_metric_merge",
    "verify_metric_update",
    "verify_program",
]

# dispatcher namespaces whose ops are cross-rank collectives
COLLECTIVE_NAMESPACES = frozenset({"c10d", "_c10d_functional", "c10d_functional"})
# c10d ops that are bookkeeping, not communication
_C10D_LOCAL = frozenset({"wait", "wait_tensor", "monitored_barrier_"})

_64BIT_FLOAT = frozenset({torch.float64, torch.complex128})
_64BIT_INT = frozenset({torch.int64, torch.uint64})
_NARROWING = {
    torch.float64: torch.float32,
    torch.int64: torch.int32,
    torch.complex128: torch.complex64,
}

_HOST_SCALAR_OPS = frozenset({"aten._local_scalar_dense.default"})
_DATA_DEPENDENT = (DataDependentOutputException, DynamicOutputShapeException)

_TORCH_DIR = os.path.dirname(os.path.abspath(torch.__file__))
_ANALYSIS_DIR = os.path.dirname(os.path.abspath(__file__))
_SKIP_DIRS = (_TORCH_DIR, _ANALYSIS_DIR, os.path.dirname(os.__file__))
_PACKAGE_PARENT = os.path.dirname(os.path.dirname(_ANALYSIS_DIR))
_AXIS_FILE = os.path.join("torcheval_tpu_torch", "parallel", "_axis.py")


def _provenance(depth: int = 2) -> Tuple[str, bool]:
    """``("file:line (function)", through_narrow_64)`` of the innermost
    caller outside torch, the standard library and this package's
    analysis layer, from ``depth`` frames up; the flag says whether
    ``convert.narrow_64`` is on the stack."""
    frame = sys._getframe(depth)
    where = None
    narrowed = False
    while frame is not None:
        code = frame.f_code
        filename = code.co_filename
        if code.co_name == "narrow_64" and filename.endswith(
            os.path.join("utils", "convert.py")
        ):
            narrowed = True
        if where is None and not filename.startswith(_SKIP_DIRS):
            rel = filename
            if filename.startswith(_PACKAGE_PARENT + os.sep):
                rel = os.path.relpath(filename, _PACKAGE_PARENT)
            where = f"{rel}:{frame.f_lineno} ({code.co_name})"
        frame = frame.f_back
    return where or "<unknown>", narrowed


def _tensors(obj: Any) -> Iterator[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for item in obj:
            yield from _tensors(item)
    elif isinstance(obj, dict):
        for item in obj.values():
            yield from _tensors(item)


def _map_tensors(obj: Any, fn) -> Any:
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_map_tensors(v, fn) for v in obj))
    if isinstance(obj, tuple):
        return tuple(_map_tensors(v, fn) for v in obj)
    if isinstance(obj, list):
        return [_map_tensors(v, fn) for v in obj]
    if isinstance(obj, dict):
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    return obj


@dataclass(frozen=True)
class OpRecord:
    """One op the traced program issued."""

    name: str
    provenance: str = ""


# ------------------------------------------------------------- the recorder


class _Recorder(TorchDispatchMode):
    """Records every op dispatched on this thread while active, with its
    provenance, and the collectives of the other two views (``parallel``'s
    census listener and the ``ProcessGroup`` gather listener) in one
    order."""

    def __init__(self) -> None:
        super().__init__()
        self.ops: List[OpRecord] = []
        self.collectives: List[Tuple[str, str]] = []  # (name, provenance)
        self.c10d: List[str] = []
        self.escapes: List[Tuple[str, str]] = []
        self.float64: List[Tuple[str, str]] = []
        self.narrowing: List[Tuple[str, str, str]] = []
        self.state_ids: set = set()  # ids of the fake state tensors

    # ---------------------------------------------------------- dispatch

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func)
        namespace = name.split(".", 1)[0]
        if namespace == "prim":
            return func(*args, **kwargs)
        where, narrowed = _provenance()
        if namespace in COLLECTIVE_NAMESPACES:
            op = name.split(".")[1]
            if op not in _C10D_LOCAL:
                self.c10d.append(name)
                # a ProcessGroup gather's or a parallel op's own transport
                # is already in the plan under the outer name
                if not inside_gather() and not where.startswith(_AXIS_FILE):
                    self.collectives.append((name, where))
                self.ops.append(OpRecord(name, where))
                return func(*args, **kwargs)
        if name in _HOST_SCALAR_OPS or self._is_copy_to_host(func, args, kwargs):
            self.escapes.append((name, where))
        self.ops.append(OpRecord(name, where))
        out = func(*args, **kwargs)
        self._note_dtypes(name, where, narrowed, args, kwargs, out)
        return out

    @staticmethod
    def _is_copy_to_host(func, args, kwargs) -> bool:
        """A copy between the host and an accelerator, either way: a read
        back, or an upload of host data (``torch.tensor(x, device=...)``),
        which from pageable memory also waits for the copy."""
        packet = func.overloadpacket
        if packet is torch.ops.aten._to_copy:
            src = args[0] if args else None
            dev = kwargs.get("device")
            return (
                isinstance(src, torch.Tensor)
                and dev is not None
                and (src.device.type == "cpu") != (torch.device(dev).type == "cpu")
            )
        if packet is torch.ops.aten.copy_ and len(args) >= 2:
            dst, src = args[0], args[1]
            return (
                isinstance(dst, torch.Tensor)
                and isinstance(src, torch.Tensor)
                and (dst.device.type == "cpu") != (src.device.type == "cpu")
            )
        return False

    def _note_dtypes(self, name, where, narrowed, args, kwargs, out) -> None:
        ins = list(_tensors(args)) + list(_tensors(kwargs))
        outs = list(_tensors(out))
        if any(t.dtype in _64BIT_FLOAT for t in ins + outs):
            self.float64.append((name, where))
        packet_name = name.rsplit(".", 1)[0]
        if packet_name in ("aten._to_copy", "aten.copy_") and not narrowed:
            src = args[1] if packet_name == "aten.copy_" and len(args) > 1 else (
                args[0] if args else None
            )
            dst = outs[0] if outs else None
            if (
                isinstance(src, torch.Tensor)
                and isinstance(dst, torch.Tensor)
                and _NARROWING.get(src.dtype) == dst.dtype
                and (src.is_floating_point() or src.is_complex()
                     or id(src) in self.state_ids)
            ):
                self.narrowing.append((name, where, f"{src.dtype} -> {dst.dtype}"))

    # ------------------------------------------------- the other two views

    def note_parallel(self, name: str) -> None:
        where, _ = _provenance()
        self.collectives.append((f"parallel.{name}", where))

    def note_group(self, name: str) -> None:
        where, _ = _provenance(3)  # past the group's gather wrapper
        self.collectives.append((f"ProcessGroup.{name}", where))


class _Trace:
    """Context: fake mode (when ``fake``), the dispatch recorder, and the
    ``parallel`` census and ``ProcessGroup`` gather listeners."""

    def __init__(self, fake: Optional[FakeTensorMode]) -> None:
        self.fake = fake
        self.recorder = _Recorder()
        self.error: Optional[BaseException] = None

    def __enter__(self) -> "_Recorder":
        from torcheval_tpu_torch.parallel import _axis

        _axis.add_listener(self.recorder.note_parallel)
        add_gather_listener(self.recorder.note_group)
        if self.fake is not None:
            self.fake.__enter__()
        self.recorder.__enter__()
        return self.recorder

    def __exit__(self, *exc) -> bool:
        from torcheval_tpu_torch.parallel import _axis

        try:
            self.recorder.__exit__(*exc)
            if self.fake is not None:
                self.fake.__exit__(*exc)
        finally:
            _axis.remove_listener(self.recorder.note_parallel)
            remove_gather_listener(self.recorder.note_group)
        if self.fake is None or exc[0] is None:
            return False  # a real run: its exceptions are its own
        if issubclass(exc[0], RuntimeError) and _NUMPY_ON_FAKE in str(exc[1]):
            # ``.numpy()`` / ``np.asarray`` of a fake tensor: on real data
            # a read of the tensor on the host
            self.recorder.escapes.append(("Tensor.numpy", _traceback_site(exc[2])))
        if issubclass(exc[0], Exception) and (
            issubclass(exc[0], _DATA_DEPENDENT) or self.recorder.escapes
        ):
            # the trace ends at the refused op, or at what a host escape
            # it already recorded broke (a fake tensor holds no data)
            self.error = exc[1]
            return True
        return False


_NUMPY_ON_FAKE = "not supported for tensor subclasses"


def _traceback_site(tb) -> str:
    """``file:line (function)`` of the innermost traceback frame outside
    torch, the standard library and the analysis layer."""
    where = "<unknown>"
    while tb is not None:
        code = tb.tb_frame.f_code
        if not code.co_filename.startswith(_SKIP_DIRS):
            rel = code.co_filename
            if rel.startswith(_PACKAGE_PARENT + os.sep):
                rel = os.path.relpath(rel, _PACKAGE_PARENT)
            where = f"{rel}:{tb.tb_lineno} ({code.co_name})"
        tb = tb.tb_next
    return where


def _fake_mode() -> FakeTensorMode:
    # constants a kernel closes over (cached grids, bounds) are real
    # tensors: fake mode converts them on the fly
    return FakeTensorMode(allow_non_fake_inputs=True)


def _fakeify(mode: FakeTensorMode, obj: Any, memo: Dict[int, Any]) -> Any:
    """Real tensors -> fake tensors of the same dtype, shape, strides and
    device (one fake per real tensor object, so aliasing survives)."""

    def leaf(t: torch.Tensor):
        got = memo.get(id(t))
        if got is None:
            got = memo[id(t)] = mode.from_tensor(t)
        return got

    return _map_tensors(obj, leaf)


# ------------------------------------------------------------- the report


@dataclass
class ProgramReport(Report):
    """A :class:`Report` plus the traced program's census, for callers
    that assert on structure directly. ``collectives`` is every ordered
    collective (c10d ops, ``parallel.<name>``, ``ProcessGroup.<method>``),
    ``hlo_collectives`` the c10d-op view alone, and ``jaxpr_text`` the
    traced op listing (one ``op  @ provenance`` line each)."""

    name: str = "<program>"
    collectives: Tuple[str, ...] = ()
    hlo_collectives: Tuple[str, ...] = ()
    host_escapes: Tuple[str, ...] = ()
    donated_params: Tuple[int, ...] = ()
    aliased_params: Tuple[int, ...] = ()
    jaxpr_text: str = ""
    ops: Tuple[str, ...] = ()

    def __post_init__(self):
        self.tool = "program"

    def as_dict(self) -> Dict[str, Any]:
        out = super().as_dict()
        out.update(
            name=self.name,
            collectives=list(self.collectives),
            hlo_collectives=list(self.hlo_collectives),
            host_escapes=list(self.host_escapes),
            donated_params=list(self.donated_params),
            aliased_params=list(self.aliased_params),
        )
        return out

    def count(self, op: str) -> int:
        """How many times the traced program issued ``op`` (a dispatcher
        name such as ``torcheval_tpu_torch.fused_auc_hist_.default``)."""
        return sum(1 for o in self.ops if o == op)


def _finding(report: Report, rule: str, message: str, **kw) -> None:
    report.findings.append(
        Finding(
            tool="program",
            rule=rule,
            path=getattr(report, "name", "<program>"),
            message=message,
            **kw,
        )
    )


def _flat(args: Sequence[Any]) -> List[Tuple[int, torch.Tensor]]:
    return [(i, t) for i, arg in enumerate(args) for t in _tensors(arg)]


def verify_program(
    fn,
    *args: Any,
    name: Optional[str] = None,
    donate_argnums: Sequence[int] = (),
    expect_collectives: Optional[Union[int, Sequence[str]]] = None,
    expect_hlo_collectives: Optional[Union[int, Sequence[str]]] = None,
    allow_host_escapes: bool = False,
    check_dtypes: bool = True,
    compile_hlo: bool = True,
    state_argnums: Sequence[int] = (),
) -> ProgramReport:
    """Statically verify one program against the rule set.

    ``args`` may hold real tensors, on any device: each becomes a fake
    tensor of the same dtype, shape and device before ``fn`` runs, so
    nothing executes. With ``donate_argnums`` (and ``compile_hlo``), every
    donated tensor must be matched by an output that ``_fuse`` would write
    in place (the same storage, or the same dtype and shape).
    ``expect_collectives`` pins the ordered collective census (an int pins
    the count, a sequence the names); ``expect_hlo_collectives`` the
    c10d-op view. ``state_argnums`` names the arguments that are metric
    states, where int64 is flagged (the donated arguments always are).
    """
    label = name or getattr(fn, "__name__", None) or "<program>"
    report = ProgramReport(tool="program", name=label, checked=1)
    mode = _fake_mode()
    memo: Dict[int, Any] = {}
    fake_args = tuple(_fakeify(mode, a, memo) for a in args)
    trace = _Trace(mode)
    watched = set(donate_argnums) | set(state_argnums)
    trace.recorder.state_ids = {
        id(t) for i, t in _flat(fake_args) if i in watched
    }
    out = None
    with trace as rec:
        out = fn(*fake_args)
    refused = trace.error
    escapes = [n for n, _ in rec.escapes]
    if isinstance(refused, _DATA_DEPENDENT):
        func = getattr(refused, "func", None)
        op = str(func) if func is not None else type(refused).__name__
        where = rec.ops[-1].provenance if rec.ops else "<unknown>"
        if not rec.escapes or rec.escapes[-1][0] != op:
            rec.escapes.append((op, where))
            escapes.append(op)
    report.host_escapes = tuple(escapes)
    report.collectives = tuple(n for n, _ in rec.collectives)
    report.hlo_collectives = tuple(rec.c10d)
    report.ops = tuple(o.name for o in rec.ops)
    report.jaxpr_text = "\n".join(f"{o.name}  @ {o.provenance}" for o in rec.ops)
    if not allow_host_escapes:
        for op, where in rec.escapes:
            _finding(
                report,
                "host-callback",
                f"host escape `{op}` in the traced program at {where} -- "
                "on a card it reads device data back to the host every "
                "step and breaks the async dispatch contract",
            )
    if check_dtypes:
        for op, where in rec.float64[:1]:
            _finding(
                report,
                "dtype-64bit",
                f"64-bit float flows through `{op}` at {where}: the "
                "reference holds float32 (x64 off), so numerics differ"
                + (f" ({len(rec.float64)} op(s) in all)" if len(rec.float64) > 1 else ""),
            )
        for i, t in _flat(args):
            if i in watched and t.dtype in _64BIT_INT:
                _finding(
                    report,
                    "dtype-64bit",
                    f"state argument {i} is {t.dtype}: the reference "
                    "holds 32-bit integer state (x64 off), so the "
                    "state_dicts do not cross-load bit for bit",
                )
                break
        if refused is None:
            for t in _tensors(out):
                if t.dtype in _64BIT_INT:
                    _finding(
                        report,
                        "dtype-64bit",
                        f"program output is {t.dtype}: the reference "
                        "returns 32-bit integers (x64 off)",
                    )
                    break
        for op, where, cast in rec.narrowing:
            _finding(
                report,
                "dtype-narrowing",
                f"silent 64->32-bit cast ({cast}) in `{op}` at {where}: "
                "the wire-downcast bug class -- narrow through "
                "utils.convert.narrow_64 or range-check it",
            )
    if expect_collectives is not None:
        _check_census(report, report.collectives, expect_collectives)
    if expect_hlo_collectives is not None:
        _check_census(report, report.hlo_collectives, expect_hlo_collectives)
    if donate_argnums and compile_hlo and refused is None:
        _check_donation(report, fake_args, tuple(donate_argnums), out)
    return set_last_report(report)


def _check_donation(report: ProgramReport, fake_args, donate_argnums, out) -> None:
    flat = _flat(fake_args)
    donated = [j for j, (i, _) in enumerate(flat) if i in donate_argnums]
    report.donated_params = tuple(donated)
    outs = list(_tensors(out))
    used = set()
    aliased = []
    # first the outputs that ARE the donated tensors (written in place)
    for j in donated:
        t = flat[j][1]
        for k, o in enumerate(outs):
            if k not in used and o is t:
                used.add(k)
                aliased.append(j)
                break
    for j in donated:
        if j in aliased:
            continue
        t = flat[j][1]
        for k, o in enumerate(outs):
            if k not in used and o.dtype == t.dtype and o.shape == t.shape:
                used.add(k)
                aliased.append(j)
                break
    report.aliased_params = tuple(sorted(aliased))
    missing = [j for j in donated if j not in aliased]
    buffers = [j for j in missing if flat[j][1].dim() > 0]
    scalars = [j for j in missing if j not in buffers]
    if buffers:
        _finding(
            report,
            "donated-not-aliased",
            f"donated parameter(s) {buffers} have no output of their dtype "
            "and shape: _fuse cannot write the new state into the live "
            "buffer, so the zero-realloc contract silently does not hold",
        )
    if scalars:
        _finding(
            report,
            "donated-not-aliased",
            f"donated 0-d scalar parameter(s) {scalars} not written in "
            "place (reallocating a scalar is free; flagged for audit only)",
            severity="warning",
        )


def _check_census(
    report: ProgramReport,
    got: Tuple[str, ...],
    expect: Union[int, Sequence[str]],
) -> None:
    if isinstance(expect, int):
        if len(got) != expect:
            _finding(
                report,
                "collective-census",
                f"expected {expect} collective(s), found {len(got)}: "
                f"{list(got)}",
            )
    elif tuple(got) != tuple(expect):
        _finding(
            report,
            "collective-census",
            f"collective sequence {list(got)} != declared expectation "
            f"{list(expect)} (order matters: reordering breaks rank "
            "lockstep even at equal counts)",
        )


# -------------------------------------------------- donation (call layer)


def _buffer_key(leaf: Any):
    if isinstance(leaf, torch.Tensor):
        try:
            return ("ptr", leaf.device.type, leaf.untyped_storage().data_ptr())
        except Exception:  # a tensor without storage (fake, meta): identity
            return ("id", id(leaf))
    return None


def check_donation_aliasing(
    args: Sequence[Any],
    donate_argnums: Sequence[int],
    *,
    name: str = "<call>",
) -> Report:
    """Call-layer donation soundness for one concrete call: no storage may
    appear twice among the donated leaves (two in-place writes into one
    buffer -- one result silently overwrites the other), and no donated
    storage may ALSO be passed un-donated (it would be read after the
    in-place write consumed it). Keyed by ``untyped_storage().data_ptr()``,
    so two views of one buffer count as one."""
    report = Report(tool="program")
    report.checked = 1
    donate = set(donate_argnums)
    seen_donated: Dict[Any, str] = {}
    plain: Dict[Any, str] = {}
    for i, arg in enumerate(args):
        for j, leaf in enumerate(_tensors(arg)):
            key = _buffer_key(leaf)
            if key is None:
                continue
            where = f"arg {i} leaf {j}"
            if i in donate:
                if key in seen_donated:
                    report.findings.append(
                        Finding(
                            tool="program",
                            rule="donated-twice",
                            path=name,
                            message=(
                                f"the same buffer is donated at "
                                f"{seen_donated[key]} and {where}: both "
                                "new states are written into one buffer "
                                "-- one result silently overwrites the "
                                "other"
                            ),
                        )
                    )
                seen_donated[key] = where
            else:
                plain[key] = where
    for key, where in seen_donated.items():
        if key in plain:
            report.findings.append(
                Finding(
                    tool="program",
                    rule="donated-also-read",
                    path=name,
                    message=(
                        f"buffer donated at {where} is also passed "
                        f"un-donated at {plain[key]}: it will be read "
                        "after the in-place write consumed it"
                    ),
                )
            )
    return report


# ------------------------------------------------------- metric verifiers


def _normalized_plan(metric, *args, **kwargs):
    """The metric's update plan as an ``UpdatePlan``, or None when it has
    none."""
    from torcheval_tpu_torch.metrics.metric import as_update_plan

    return as_update_plan(metric._update_plan(*args, **kwargs), metric)


def _bucketed_dynamic(plan) -> Tuple[Any, ...]:
    """The masked kernel's arguments at bucket shapes
    (``_bucket.bucket_shapes``, the runtime's own reading): each labelled
    tensor as zeros of its dtype and device, plus the int32 valid-extent
    vector, without touching the knob or the data."""
    from torcheval_tpu_torch.metrics import _bucket

    shapes = _bucket.bucket_shapes(plan)
    padded = tuple(
        arg if shape is None or not isinstance(arg, torch.Tensor)
        else torch.zeros(shape, dtype=arg.dtype, device=arg.device)
        for arg, shape in zip(plan.dynamic, shapes.shapes)
    )
    return padded + (torch.tensor(shapes.extents, dtype=torch.int32, device=shapes.device),)


def _fused(kernel, config, transform: bool, donate: bool):
    """The program ``_fuse`` runs for one plan (its eager form)."""
    from torcheval_tpu_torch.metrics import _fuse

    def fused(states, *dyn):
        dyn = tuple(_fuse.materialize(a) for a in dyn)
        outs = _fuse._outputs(kernel, config, states, dyn, transform)
        return _fuse._apply(states, outs, transform, donate)

    fused.__name__ = getattr(kernel, "__name__", "fused")
    return fused


def verify_metric_update(
    metric,
    *args: Any,
    donate: Optional[bool] = None,
    expect_collectives: Union[int, Sequence[str]] = 0,
    **update_kwargs: Any,
) -> Optional[ProgramReport]:
    """Statically verify a metric's fused update program: no host escapes,
    zero collectives (a LOCAL update must never sync), dtype safety, and
    -- by default, whatever the process donation knob -- donation
    soundness of the donated program plus call-layer aliasing of the
    metric's live states. A plan with a masked twin is verified at its
    bucket shapes too. Returns ``None`` for metrics whose update has no
    plan (host-side text metrics, buffered appends)."""
    plan = _normalized_plan(metric, *args, **update_kwargs)
    if plan is None:
        return None
    states = tuple(getattr(metric, n) for n in plan.state_names)
    if donate is None:
        donate = metric._donated_update
    name = f"{type(metric).__name__}.update"
    report = verify_program(
        _fused(plan.kernel, plan.config, plan.transform, donate),
        states,
        *plan.dynamic,
        name=name,
        donate_argnums=(0,) if donate else (),
        state_argnums=(0,),
        expect_collectives=expect_collectives,
    )
    if plan.masked_kernel is not None and plan.batch_axes:
        # under config.shape_bucketing() the metric runs the MASKED kernel
        # over padded buckets: certify that program too
        report.extend(
            verify_program(
                _fused(plan.masked_kernel, plan.config, plan.transform, donate),
                states,
                *_bucketed_dynamic(plan),
                name=f"{name}[bucketed]",
                donate_argnums=(0,) if donate else (),
                state_argnums=(0,),
                expect_collectives=expect_collectives,
            )
        )
    if donate:
        report.extend(
            check_donation_aliasing(
                (states,) + tuple(plan.dynamic), (0,), name=report.name
            )
        )
    return set_last_report(report)


def _state_values(metric) -> Dict[str, Any]:
    """Tensor-valued states (tensors, lists and dicts of them); int and
    float states stay host scalars."""
    out = {}
    for sname in metric._state_name_to_default:
        value = getattr(metric, sname)
        if isinstance(value, (torch.Tensor, list, dict)):
            out[sname] = value
    return out


def _escape_report(name: str, exc: BaseException, rule: str) -> ProgramReport:
    report = ProgramReport(tool="program", name=name, checked=1)
    first_line = (str(exc).strip().splitlines() or [type(exc).__name__])[0]
    _finding(report, rule, first_line, severity="warning")
    return report


def verify_metric_compute(metric) -> ProgramReport:
    """Trace ``compute()`` over fake states. A compute that reads device
    values on the host (``float(t)``, ``if t:``, a data-dependent shape)
    is reported as a ``compute-host-sync`` WARNING: compute is host-side
    finalization, off the hot path (the hard no-host-sync contract binds
    ``update``)."""
    clone = copy.deepcopy(metric)
    names = sorted(_state_values(clone))
    name = f"{type(metric).__name__}.compute"

    def run(state_values):
        for sname, value in zip(names, state_values):
            setattr(clone, sname, value)
        return clone.compute()

    values = tuple(_state_values(clone)[n] for n in names)
    try:
        report = verify_program(
            run,
            values,
            name=name,
            expect_collectives=0,
            compile_hlo=False,
            allow_host_escapes=True,
        )
    except RuntimeError as exc:
        # ONLY the buffered no-data precondition is a non-verdict; any
        # other RuntimeError is a genuine compute() defect
        if "call update() before" not in str(exc) and "no data" not in str(exc):
            raise
        report = _escape_report(name, exc, "compute-untraceable")
        return set_last_report(report)
    if report.host_escapes:
        _finding(
            report,
            "compute-host-sync",
            f"compute() reads device values on the host "
            f"({', '.join(report.host_escapes)})",
            severity="warning",
        )
        report = set_last_report(report)
    return report


def verify_metric_merge(metric) -> ProgramReport:
    """Trace the declarative ``merge_state`` program over two fake
    replicas: no collectives (merge is local math -- collectives belong to
    the sync transport), dtype-safe. A merge that reads device values on
    the host (the keyed table reassembles its key union in numpy) is a
    ``merge-host-sync`` WARNING, as a host-reading compute is: the JAX
    verifier cannot trace such a merge at all."""
    mine = copy.deepcopy(metric)
    theirs = copy.deepcopy(metric)
    names = sorted(_state_values(mine))

    def run(mine_states, theirs_states):
        for sname, value in zip(names, mine_states):
            setattr(mine, sname, value)
        for sname, value in zip(names, theirs_states):
            setattr(theirs, sname, value)
        mine.merge_state([theirs])
        return tuple(getattr(mine, sname) for sname in names)

    values_mine = tuple(_state_values(mine)[n] for n in names)
    values_theirs = tuple(_state_values(theirs)[n] for n in names)
    report = verify_program(
        run,
        values_mine,
        values_theirs,
        name=f"{type(metric).__name__}.merge_state",
        expect_collectives=0,
        compile_hlo=False,
        allow_host_escapes=True,
        state_argnums=(0, 1),
    )
    if report.host_escapes:
        _finding(
            report,
            "merge-host-sync",
            "merge_state() reads device values on the host "
            f"({', '.join(report.host_escapes)}): a host-side merge (the "
            "keyed table's key union), off the update path",
            severity="warning",
        )
        report = set_last_report(report)
    return report


# --------------------------------------------- zero-added-collectives diff


def _trace_collectives(fn, args) -> Tuple[str, ...]:
    mode = _fake_mode()
    memo: Dict[int, Any] = {}
    fake_args = tuple(_fakeify(mode, a, memo) for a in args)
    trace = _Trace(mode)
    with trace as rec:
        fn(*fake_args)
    return tuple(n for n, _ in rec.collectives)


def compare_collective_sequences(
    baseline_fn,
    baseline_args: Sequence[Any],
    synced_fn,
    synced_args: Sequence[Any],
    *,
    name: str = "<step>",
    allow_added: Union[int, Sequence[str]] = 0,
) -> ProgramReport:
    """Trace both step programs and diff their ordered collective
    sequences -- the zero-added-collectives property as one call.
    ``allow_added`` relaxes the pin where an addition is the declared
    cost: an int bounds the number of added ops, a sequence pins exactly
    which ops may be added (as a multiset)."""
    base = _trace_collectives(baseline_fn, baseline_args)
    synced = _trace_collectives(synced_fn, synced_args)
    report = ProgramReport(tool="program", name=name, checked=2)
    report.collectives = synced
    added = list(synced)
    for op in base:
        if op in added:
            added.remove(op)
    if isinstance(allow_added, int):
        over_budget = len(added) > allow_added
    else:
        extra = list(added)
        for op in allow_added:
            if op in extra:
                extra.remove(op)
        over_budget = bool(extra)
    if over_budget:
        _finding(
            report,
            "added-collectives",
            f"synced step collectives {list(synced)} vs baseline "
            f"{list(base)}: added {added} exceeds the declared budget "
            f"{allow_added!r} -- the metric sync no longer rides the "
            "step's existing collectives",
        )
    return set_last_report(report)


# --------------------------------------------------- runtime pin wrappers


def _state_device(metric) -> torch.device:
    return torch.device(getattr(metric, "device", "cpu"))


class _HostEscapeError(RuntimeError):
    pass


def _guarded_update(metric, args: Sequence[Any], kwargs=None) -> None:
    """One real update that must not read the device back: on CUDA under
    ``set_sync_debug_mode("error")``, on the CPU under the dispatch
    recorder's host-escape rule."""
    kwargs = kwargs or {}
    if _state_device(metric).type == "cuda":
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            metric.update(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        return
    trace = _Trace(None)
    with trace as rec:
        metric.update(*args, **kwargs)
    if rec.escapes:
        raise _HostEscapeError(
            f"{type(metric).__name__}.update read device data back: "
            + ", ".join(f"{op} at {where}" for op, where in rec.escapes)
        )


def assert_update_transfer_free(metric, args: Sequence[Any], *, warm: int = 6):
    """RUNTIME pin: after ``warm`` settling updates, one more
    ``update(*args)`` must run without reading the device back -- the
    dynamic counterpart of :func:`verify_metric_update`'s static
    host-escape check."""
    for _ in range(warm):
        metric.update(*args)
    _guarded_update(metric, args)
    return metric


def _ptrs(metric, state_name: str) -> Tuple[int, ...]:
    value = getattr(metric, state_name)
    return tuple(t.untyped_storage().data_ptr() for t in _tensors(value))


def assert_donated_update_in_place(
    metric,
    args: Sequence[Any],
    state_name: str,
    *,
    warm: int = 3,
    steps: int = 1,
):
    """RUNTIME pin: with donation enabled, after ``warm`` settling updates
    every one of ``steps`` further updates must write ``state_name`` in
    place (its storage pointer unchanged), and the final one must also be
    transfer-free."""
    from torcheval_tpu_torch import config

    with config.update_donation(True):
        for _ in range(warm):
            metric.update(*args)
        ptr = _ptrs(metric, state_name)
        for _ in range(max(steps - 1, 0)):
            metric.update(*args)
            assert _ptrs(metric, state_name) == ptr, (
                f"{type(metric).__name__}.{state_name} was reallocated by "
                "a donated update (zero-realloc contract)"
            )
        _guarded_update(metric, args)
        assert _ptrs(metric, state_name) == ptr, (
            f"{type(metric).__name__}.{state_name} was reallocated by a "
            "donated update (zero-realloc contract)"
        )
    return metric
