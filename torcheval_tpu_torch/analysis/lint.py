"""AST lint: the house rules that keep regressing, as a rule registry.

The counterpart of ``torcheval_tpu/analysis/lint.py``, with the same rule
ids. Each rule codifies a convention the port enforces by review, in its
torch form:

- ``ffi-import``: a ``ctypes.CDLL``, ``torch.ops.load_library`` or
  ``torch.utils.cpp_extension.load*`` outside ``ops/_kernels.py``. The
  hand-written kernels build on first use and load in one place, under
  one lock, keyed by a hash of their source and flags; a second loader
  would build or load a library behind that cache's back.
- ``env-truthy``: boolean env knobs must parse through
  ``config.env_truthy`` / ``config._TRUTHY`` -- inline truthy tuples
  drift apart.
- ``host-sync``: ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``torch.cuda.synchronize()`` or ``np.asarray``/``np.array``/
  ``np.ascontiguousarray`` in an update-reachable module: on a card each
  reads device data back to the host (a stream synchronization) on the
  hot path.
- ``time-in-jit``: a clock read inside a CUDA-graph capture -- a
  ``with torch.cuda.graph(...)`` block, or the lines between a
  ``capture_begin`` and a ``capture_end`` -- or inside a plan kernel
  handed to ``_fuse`` (the kernel of an ``UpdatePlan``, of an
  ``_update_plan`` tuple, or of a ``fused_accumulate``/``fused_transform``
  call). A captured graph replays device work only, so such a read is
  frozen at capture: silently wrong, not just slow.
- ``shard-map-import``: an import from the private
  ``torch.distributed._tensor``, where it must be
  ``torch.distributed.tensor`` (the public home of DTensor; the private
  module is a deprecated alias that moves between releases).
- ``bare-lock``: a ``threading.Lock/RLock/Condition`` construction with
  no ``# tev: guarded-by=<lock>`` binding anywhere in its scope -- a lock
  nobody declares state for is a lock the concurrency verifier
  (``analysis/locks.py``) cannot check.

Scope model: ``host-sync`` applies only to update-reachable modules
(``metrics/functional/``, ``ops/``, ``metrics/_fuse.py``,
``metrics/_bucket.py``, ``metrics/sharded.py``; ``ops/_kernels.py``, the
build and load code, and ``metrics/functional/text/``, which tokenizes
Python strings, are exempt). Paths are taken from the innermost
package root on the path (``torcheval_tpu_torch/`` or
``torcheval_tpu/``), so the same model applies to either tree. Host-side
protocol code (``distributed.py``, ``synclib.py``) legitimately touches
numpy. A file can override its classification with a
``# tev: scope=jit`` / ``# tev: scope=host`` comment in its first lines.
``time-in-jit`` needs no scope: its capture blocks and plan kernels are
the scope.

Suppression: ``# tev: disable=<rule-id>[,<rule-id>...] -- <reason>`` on
the offending line. The reason is mandatory -- a reasonless suppression is
itself a finding (``bad-suppression``). Suppressed findings stay in the
JSON report, flagged, so they remain auditable.

Stdlib-only by design: the lint must not need torch.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

from torcheval_tpu_torch.analysis.annotations import (
    CONCURRENCY_RULE_IDS,
    lock_ctor_kind,
    parse_guarded_lines,
    parse_suppressions,
)
from torcheval_tpu_torch.analysis.report import Finding, Report, set_last_report

__all__ = [
    "LintRule",
    "RULES",
    "lint_file",
    "lint_paths",
    "register_rule",
]

_SCOPE_RE = re.compile(r"#\s*tev:\s*scope=(jit|host)\b")

# Accepted boolean env spellings — mirrors config._TRUTHY/_FALSY (kept
# literal here so the lint stays importable without the package root).
_BOOL_SPELLINGS = frozenset(
    {"1", "true", "yes", "on", "0", "false", "no", "off"}
)

# Modules on the update path: host-sync idioms there read device data
# back on every step. Matched against the path relative to the innermost
# package root.
_JIT_REACHABLE_PREFIXES = (
    "metrics/functional/",
    "ops/",
)
_JIT_EXEMPT_PREFIXES = (
    # text metrics tokenize Python strings on the host by design
    "metrics/functional/text/",
    # the kernel build and load code runs once, on the host
    "ops/_kernels.py",
)
_JIT_REACHABLE_FILES = (
    "metrics/sharded.py",  # in-step sync bodies
    "metrics/_fuse.py",  # the plan runner and its CUDA-graph capture
    "metrics/_bucket.py",  # the padding of bucketed plans
)
_PACKAGE_ROOTS = ("torcheval_tpu_torch/", "torcheval_tpu/")


def _package_relpath(path: str) -> str:
    """``path`` from the innermost package root on it, the root's own
    directory name dropped (``metrics/_fuse.py``); the normalized path
    when no root is on it."""
    norm = path.replace(os.sep, "/")
    best, root_len = -1, 0
    for root in _PACKAGE_ROOTS:
        idx = norm.rfind(root)
        if idx >= 0 and (idx == 0 or norm[idx - 1] == "/") and idx > best:
            best, root_len = idx, len(root)
    return norm[best + root_len:] if best >= 0 else norm


def is_jit_reachable(path: str, source_head: str = "") -> bool:
    """Whether ``host-sync`` applies to this file."""
    scope = _SCOPE_RE.search(source_head)
    if scope:
        return scope.group(1) == "jit"
    rel = _package_relpath(path)
    if rel in _JIT_REACHABLE_FILES:
        return True
    if any(rel.startswith(p) for p in _JIT_EXEMPT_PREFIXES):
        return False
    return any(rel.startswith(p) for p in _JIT_REACHABLE_PREFIXES)


@dataclass(frozen=True)
class LintRule:
    """One registered house rule.

    ``check(ctx)`` yields ``(line, col, message)`` violations;
    ``applies(ctx)`` gates by file (scope model above).
    """

    id: str
    description: str
    check: Callable[["_FileContext"], Iterator[Tuple[int, int, str]]]
    applies: Callable[["_FileContext"], bool] = lambda ctx: True
    severity: str = "error"


@dataclass
class _FileContext:
    path: str
    rel: str
    tree: ast.AST
    lines: List[str]
    jit: bool


RULES: Dict[str, LintRule] = {}


def register_rule(rule: LintRule) -> LintRule:
    if rule.id in RULES:
        raise ValueError(f"duplicate lint rule id {rule.id!r}")
    RULES[rule.id] = rule
    return rule


# ------------------------------------------------------------- ffi-import

_KERNEL_LOADER = "ops/_kernels.py"


def _dotted(node: ast.AST) -> str:
    """``a.b.c`` of a Name/Attribute chain ('' for anything else)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return ""
    parts.append(node.id)
    return ".".join(reversed(parts))


def _check_ffi_import(ctx: _FileContext):
    cpp_names = set()  # names bound to torch.utils.cpp_extension loaders
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ImportFrom) and (
            node.module or ""
        ).startswith("torch.utils.cpp_extension"):
            for alias in node.names:
                if alias.name.startswith("load"):
                    cpp_names.add(alias.asname or alias.name)
            yield (
                node.lineno,
                node.col_offset,
                f"import from `{node.module}`: kernels build and load "
                "only through ops/_kernels.py (one build cache, one lock)",
            )
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.startswith("torch.utils.cpp_extension"):
                    yield (
                        node.lineno,
                        node.col_offset,
                        f"`import {alias.name}`: kernels build and load "
                        "only through ops/_kernels.py",
                    )
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = _dotted(node.func)
        last = name.rsplit(".", 1)[-1]
        if (
            name in ("ctypes.CDLL", "CDLL", "ctypes.cdll.LoadLibrary")
            or name.endswith("ops.load_library")
            or (name.startswith(("torch.utils.cpp_extension.",
                                 "cpp_extension."))
                and last.startswith("load"))
            or (isinstance(node.func, ast.Name) and name in cpp_names)
        ):
            yield (
                node.lineno,
                node.col_offset,
                f"`{name}(...)` outside ops/_kernels.py: a second loader "
                "builds or loads a library behind the kernel cache's back "
                "-- load through _kernels.load",
            )


register_rule(
    LintRule(
        id="ffi-import",
        description=(
            "native libraries load only through ops/_kernels.py "
            "(ctypes.CDLL, torch.ops.load_library, cpp_extension.load*)"
        ),
        check=_check_ffi_import,
        applies=lambda ctx: ctx.rel != _KERNEL_LOADER,
    )
)


# ------------------------------------------------------------- env-truthy


def _str_elts(node: ast.AST) -> Optional[List[str]]:
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        values = []
        for elt in node.elts:
            if not (
                isinstance(elt, ast.Constant) and isinstance(elt.value, str)
            ):
                return None
            values.append(elt.value.lower())
        return values
    return None


def _check_env_truthy(ctx: _FileContext):
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Compare):
            continue
        if not any(isinstance(op, (ast.In, ast.NotIn)) for op in node.ops):
            continue
        for comparator in node.comparators:
            elts = _str_elts(comparator)
            if elts is None:
                continue
            hits = sum(1 for v in elts if v in _BOOL_SPELLINGS)
            if hits >= 2:
                yield (
                    node.lineno,
                    node.col_offset,
                    "inline truthy env-spelling tuple: use "
                    "config.env_truthy(name) (or config._TRUTHY/_FALSY) "
                    "so the accepted spellings cannot drift",
                )


register_rule(
    LintRule(
        id="env-truthy",
        description=(
            "boolean env parsing must go through config.env_truthy, "
            "not inline spelling tuples"
        ),
        check=_check_env_truthy,
        applies=lambda ctx: ctx.rel != "config.py",
    )
)


# -------------------------------------------------------------- host-sync

_HOST_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")
_NUMPY_NAMES = ("np", "numpy")
_NUMPY_SYNC_FNS = ("asarray", "array", "ascontiguousarray")


def _check_host_sync(ctx: _FileContext):
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if not isinstance(fn, ast.Attribute):
            continue
        if fn.attr in _HOST_SYNC_METHODS and not node.args and not node.keywords:
            yield (
                node.lineno,
                node.col_offset,
                f"`.{fn.attr}()` in an update-reachable module reads a "
                "device tensor back to the host on the hot path",
            )
        elif (
            fn.attr in _NUMPY_SYNC_FNS
            and isinstance(fn.value, ast.Name)
            and fn.value.id in _NUMPY_NAMES
        ):
            yield (
                node.lineno,
                node.col_offset,
                f"`np.{fn.attr}(...)` in an update-reachable module pulls "
                "a tensor operand to the host; use torch ops (or move the "
                "code to a host-side module)",
            )
        elif _dotted(fn).endswith("cuda.synchronize"):
            yield (
                node.lineno,
                node.col_offset,
                "`torch.cuda.synchronize()` in an update-reachable module "
                "stalls the host on the device every call",
            )


register_rule(
    LintRule(
        id="host-sync",
        description=(
            ".item()/.tolist()/.cpu()/.numpy()/np.asarray/"
            "torch.cuda.synchronize in update-reachable modules (a "
            "device->host read per call)"
        ),
        check=_check_host_sync,
        applies=lambda ctx: ctx.jit,
    )
)


# ------------------------------------------------------------ time-in-jit

_CLOCK_FNS = (
    "time",
    "monotonic",
    "perf_counter",
    "process_time",
    "time_ns",
    "monotonic_ns",
    "perf_counter_ns",
)
# calls whose first positional argument (or these keywords) is a plan
# kernel that `_fuse` runs, and may capture into a CUDA graph
_PLAN_CALLS = ("UpdatePlan", "fused_accumulate", "fused_transform")
_PLAN_KERNEL_KEYWORDS = ("kernel", "masked_kernel")


def _is_clock_read(node: ast.AST) -> bool:
    return (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr in _CLOCK_FNS
        and isinstance(node.func.value, ast.Name)
        and node.func.value.id == "time"
    )


def _kernel_name(node: ast.AST) -> Optional[str]:
    """The function a plan-kernel expression names: ``fn``,
    ``self._fn``/``cls._fn`` or ``partial(fn, ...)``."""
    if isinstance(node, ast.Call) and _dotted(node.func).endswith("partial"):
        return _kernel_name(node.args[0]) if node.args else None
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _plan_kernel_names(tree: ast.AST) -> set:
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            if _dotted(node.func).rsplit(".", 1)[-1] in _PLAN_CALLS:
                if node.args:
                    names.add(_kernel_name(node.args[0]))
                for kw in node.keywords:
                    if kw.arg in _PLAN_KERNEL_KEYWORDS:
                        names.add(_kernel_name(kw.value))
        elif (
            isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            and node.name == "_update_plan"
        ):
            for sub in ast.walk(node):
                if (
                    isinstance(sub, ast.Return)
                    and isinstance(sub.value, ast.Tuple)
                    and sub.value.elts
                ):
                    names.add(_kernel_name(sub.value.elts[0]))
    names.discard(None)
    return names


def _is_capture_with(item: ast.withitem) -> bool:
    expr = item.context_expr
    return isinstance(expr, ast.Call) and _dotted(expr.func).endswith(
        "cuda.graph"
    )


def _capture_ranges(tree: ast.AST) -> List[Tuple[int, int]]:
    """Line ranges between ``x.capture_begin(...)`` and the next
    ``x.capture_end()`` of the same function."""
    ranges = []
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        begins, ends = [], []
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute
            ):
                if node.func.attr == "capture_begin":
                    begins.append(node.lineno)
                elif node.func.attr == "capture_end":
                    ends.append(node.lineno)
        for lo in begins:
            later = [e for e in ends if e > lo]
            if later:
                ranges.append((lo, min(later)))
    return ranges


def _check_time_in_jit(ctx: _FileContext):
    seen = set()

    def report(node, where):
        if id(node) in seen:
            return None
        seen.add(id(node))
        return (
            node.lineno,
            node.col_offset,
            f"`time.{node.func.attr}()` {where}: a captured graph replays "
            "device work only, so the read is frozen at capture -- "
            "silently wrong, not just slow",
        )

    kernels = _plan_kernel_names(ctx.tree)
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.With, ast.AsyncWith)) and any(
            _is_capture_with(item) for item in node.items
        ):
            for stmt in node.body:
                for sub in ast.walk(stmt):
                    if _is_clock_read(sub):
                        hit = report(sub, "inside a CUDA-graph capture block")
                        if hit:
                            yield hit
        elif (
            isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            and node.name in kernels
        ):
            for sub in ast.walk(node):
                if _is_clock_read(sub):
                    hit = report(
                        sub, f"inside plan kernel `{node.name}` (run by _fuse)"
                    )
                    if hit:
                        yield hit
    ranges = _capture_ranges(ctx.tree)
    if ranges:
        for node in ast.walk(ctx.tree):
            if _is_clock_read(node) and any(
                lo < node.lineno < hi for lo, hi in ranges
            ):
                hit = report(node, "between capture_begin and capture_end")
                if hit:
                    yield hit


register_rule(
    LintRule(
        id="time-in-jit",
        description=(
            "clock reads inside a CUDA-graph capture or a plan kernel are "
            "frozen at capture"
        ),
        check=_check_time_in_jit,
    )
)


# -------------------------------------------------------- shard-map-import

_PRIVATE_DTENSOR = "torch.distributed._tensor"


def _check_shard_map_import(ctx: _FileContext):
    message = (
        "import from the private `torch.distributed._tensor`: DTensor's "
        "public home is `torch.distributed.tensor` (the private alias is "
        "deprecated and moves between releases)"
    )
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if mod == _PRIVATE_DTENSOR or mod.startswith(_PRIVATE_DTENSOR + "."):
                yield (node.lineno, node.col_offset, message)
            elif mod == "torch.distributed" and any(
                a.name == "_tensor" for a in node.names
            ):
                yield (node.lineno, node.col_offset, message)
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == _PRIVATE_DTENSOR or alias.name.startswith(
                    _PRIVATE_DTENSOR + "."
                ):
                    yield (node.lineno, node.col_offset, message)
        elif isinstance(node, ast.Attribute) and _dotted(node) == _PRIVATE_DTENSOR:
            yield (node.lineno, node.col_offset, message)


register_rule(
    LintRule(
        id="shard-map-import",
        description=(
            "DTensor must be imported from torch.distributed.tensor, not "
            "the private torch.distributed._tensor"
        ),
        check=_check_shard_map_import,
    )
)


# -------------------------------------------------------------- bare-lock

def _check_bare_lock(ctx: _FileContext):
    """Every lock construction must have a ``# tev: guarded-by=<lock>``
    binding in its scope (class body + methods for ``self.<lock>``,
    top level for module globals) declaring WHAT it protects — else the
    concurrency verifier has nothing to enforce for it."""
    guarded = parse_guarded_lines(ctx.lines)
    class_ranges = [
        (node, node.lineno, getattr(node, "end_lineno", node.lineno))
        for node in ast.walk(ctx.tree)
        if isinstance(node, ast.ClassDef)
    ]

    def scope_locks_named(line: int) -> set:
        """Lock names bound by guarded-by comments in the same scope as
        a construction at ``line`` (innermost class, or module level)."""
        enclosing = None
        for node, lo, hi in class_ranges:
            if lo <= line <= hi:
                if enclosing is None or lo > enclosing[1]:
                    enclosing = (node, lo, hi)
        named = set()
        for gline, lock in guarded.items():
            if enclosing is not None:
                if enclosing[1] <= gline <= enclosing[2]:
                    named.add(lock)
            else:
                in_class = any(lo <= gline <= hi for _, lo, hi in class_ranges)
                if not in_class:
                    named.add(lock)
        return named

    assigned_ctors = set()
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.Assign, ast.AnnAssign)):
            continue
        value = node.value
        if value is None or lock_ctor_kind(value) is None:
            continue
        assigned_ctors.add(id(value))
        targets = (
            node.targets if isinstance(node, ast.Assign) else [node.target]
        )
        name = None
        for target in targets:
            if isinstance(target, ast.Name):
                name = target.id
            elif (
                isinstance(target, ast.Attribute)
                and isinstance(target.value, ast.Name)
                and target.value.id == "self"
            ):
                name = target.attr
        if name is None:
            continue  # exotic target: the anonymous arm below reports it
        if name not in scope_locks_named(node.lineno):
            yield (
                node.lineno,
                node.col_offset,
                f"bare lock `{name}`: no `# tev: guarded-by={name}` "
                "binding in its scope declares what this lock protects "
                "— bind the guarded state (analysis/locks.py enforces "
                "the binding), or this lock is unverifiable",
            )
    for node in ast.walk(ctx.tree):
        if (
            isinstance(node, ast.Call)
            and lock_ctor_kind(node) is not None
            and id(node) not in assigned_ctors
        ):
            yield (
                node.lineno,
                node.col_offset,
                "anonymous lock construction: a lock that is not bound "
                "to a name (module global or self attribute) cannot "
                "carry a guarded-by binding and cannot be verified",
            )


register_rule(
    LintRule(
        id="bare-lock",
        description=(
            "threading.Lock/RLock/Condition constructions must carry a "
            "guarded-by binding naming what they protect"
        ),
        check=_check_bare_lock,
    )
)


# ----------------------------------------------------------------- driver


def _parse_suppressions(
    lines: List[str],
) -> Tuple[Dict[int, Tuple[set, str]], List[Tuple[int, int, str]]]:
    """Per-line suppression map + bad (reasonless/unknown) suppression
    findings — the shared ``annotations.py`` grammar, validated against
    the lint registry PLUS the concurrency-verifier rule ids (a
    ``# tev: disable=cross-thread-collective`` comment in a threaded
    module must not read as a typo to the plain lint)."""
    return parse_suppressions(lines, set(RULES) | CONCURRENCY_RULE_IDS)


def _select_rules(rules: Optional[Iterable[str]]) -> List[LintRule]:
    """Resolve rule ids to :class:`LintRule` objects, rejecting unknown
    ids with a message naming the catalogue (raw ``KeyError`` is useless
    to a CLI/API caller who mistyped a rule)."""
    if rules is None:
        return list(RULES.values())
    ids = list(rules)
    unknown = sorted(set(ids) - set(RULES))
    if unknown:
        raise ValueError(
            f"unknown rule(s) {unknown}; known: {sorted(RULES)}"
        )
    return [RULES[r] for r in ids]


def lint_file(path: str, *, rules: Optional[Iterable[str]] = None) -> Report:
    """Lint one Python file against the registered rules."""
    selected = _select_rules(rules)
    report = Report(tool="lint")
    try:
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
    except (OSError, UnicodeDecodeError) as exc:
        report.findings.append(
            Finding(
                tool="lint",
                rule="parse-error",
                path=path,
                message=f"unreadable: {exc}",
                severity="warning",
            )
        )
        return report
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as exc:
        report.findings.append(
            Finding(
                tool="lint",
                rule="parse-error",
                path=path,
                line=exc.lineno or 0,
                message=f"syntax error: {exc.msg}",
                severity="warning",
            )
        )
        return report

    lines = source.splitlines()
    head = "\n".join(lines[:5])
    ctx = _FileContext(
        path=path,
        rel=_package_relpath(path),
        tree=tree,
        lines=lines,
        jit=is_jit_reachable(path, head),
    )
    suppressions, bad = _parse_suppressions(lines)
    for line, col, message in bad:
        report.findings.append(
            Finding(
                tool="lint",
                rule="bad-suppression",
                path=path,
                line=line,
                col=col,
                message=message,
            )
        )

    report.checked = 1
    for rule in selected:
        if not rule.applies(ctx):
            continue
        for line, col, message in rule.check(ctx):
            ids_reason = suppressions.get(line)
            suppressed = bool(ids_reason and rule.id in ids_reason[0])
            report.findings.append(
                Finding(
                    tool="lint",
                    rule=rule.id,
                    path=path,
                    line=line,
                    col=col,
                    message=message,
                    severity=rule.severity,
                    suppressed=suppressed,
                    suppress_reason=ids_reason[1] if suppressed else "",
                )
            )
    report.findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return report


def _iter_py_files(paths: Iterable[str]) -> Iterator[str]:
    for path in paths:
        if os.path.isdir(path):
            for root, dirs, files in os.walk(path):
                dirs[:] = sorted(
                    d
                    for d in dirs
                    if d not in ("__pycache__", ".git", "node_modules")
                )
                for name in sorted(files):
                    if name.endswith(".py"):
                        yield os.path.join(root, name)
        elif path.endswith(".py"):
            yield path


def lint_paths(
    paths: Iterable[str], *, rules: Optional[Iterable[str]] = None
) -> Report:
    """Lint every ``.py`` under ``paths`` (files or directories); the
    result becomes :func:`torcheval_tpu_torch.analysis.last_report`.

    A path that does not exist is an ERROR finding (``missing-path``),
    not a silent no-op: a mistyped/renamed directory must fail the
    gate loudly, never turn it green by linting nothing."""
    _select_rules(rules)  # reject unknown ids even when no file matches
    report = Report(tool="lint")
    paths = list(paths)
    for path in paths:
        if not os.path.exists(path):
            report.findings.append(
                Finding(
                    tool="lint",
                    rule="missing-path",
                    path=path,
                    message=(
                        "path does not exist — nothing here was linted "
                        "(mistyped argument, renamed directory, or wrong "
                        "working directory?)"
                    ),
                )
            )
        elif not os.path.isdir(path) and not path.endswith(".py"):
            # Same loud-failure contract as missing-path: an explicitly
            # named file the walker would skip must not read as linted.
            report.findings.append(
                Finding(
                    tool="lint",
                    rule="unlinted-path",
                    path=path,
                    message=(
                        "explicitly-named file is not a .py file — it was "
                        "not linted (pass the containing directory or a "
                        "Python file)"
                    ),
                )
            )
    for path in _iter_py_files(paths):
        report.extend(lint_file(path, rules=rules))
    return set_last_report(report)
