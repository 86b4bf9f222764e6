"""Lock-discipline static analysis: guarded-by bindings and lock order.

The counterpart of ``torcheval_tpu/analysis/locks.py``, and the
host-threading sibling of the program verifier: a worker-thread leak, a
process-global-fence deadlock, a writer/main-thread collective-sequence
race and a flight-ring generation race were all caught by review, not by
a gate. This module turns that review checklist into rules over the AST
(stdlib-only -- the concurrency gate runs without torch, like the lint).
Module names are taken from the innermost package root on a file's path
(``torcheval_tpu_torch/`` or ``torcheval_tpu/``), so no two files of one
package share a name and imports between them resolve:

- **Lock inventory**: every ``threading.Lock/RLock/Condition``
  construction — ``self._lock = threading.Lock()`` in ``__init__``, a
  dataclass ``field(default_factory=threading.Lock)``, or a module
  global — becomes a named lock (``Class._lock`` / ``_GLOBAL_LOCK``).
- **unguarded-state**: a lock-owning class (or module) must bind each
  shared mutable attribute — one mutated outside ``__init__`` — to its
  lock with ``# tev: guarded-by=<lock>`` on the attribute's definition
  line. State rooted in ``threading.local`` or frozen via
  ``MappingProxyType`` (and synchronization primitives themselves) is
  auto-exempt; a deliberately lock-free field carries a reasoned
  ``# tev: disable=unguarded-state -- <why>`` instead.
- **guarded-field**: a bound attribute read or written outside a
  ``with <lock>`` scope (``__init__`` excepted) is a race finding -- the
  flight-ring class, caught at the line.
- **blocking-under-lock**: ``time.sleep``, ``queue.get``, ``.wait()``,
  ``.join()``, a collective issue, or a call into a function that
  lexically blocks, made while a lock is held — the convoy/deadlock
  feeder. ``Condition.wait/wait_for`` on the held lock itself is the
  one legal shape (it releases the lock) and is exempt.
- **lock-order-cycle**: nested ``with``-acquisitions (lexical, plus
  calls resolved through the module universe) build a directed
  acquisition graph; a cycle is a would-deadlock finding carrying every
  edge's acquisition stack -- the fence-deadlock class, caught
  statically.

Resolution is deliberately name-based and conservative: ``self.x`` in
the defining class, module globals, ``from``-imports, module aliases,
``GLOBAL = ClassName()`` instances, and ``g: Optional[ClassName]``
annotations. What cannot be resolved produces no finding (cross-object
attribute chains like ``other.health._lock`` are out of scope; the
deterministic-schedule harness covers them dynamically).

Suppression uses the lint grammar (``# tev: disable=<rule> -- reason``)
and suppressed findings stay in the report, flagged, for audit.
"""

from __future__ import annotations

import ast
import os
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

from torcheval_tpu_torch.analysis.annotations import (
    CONCURRENCY_RULE_IDS,
    LOCK_TYPE_NAMES as _LOCK_TYPES,
    lock_ctor_kind as _lock_ctor_kind,
    parse_guarded_lines,
    parse_suppressions,
    parse_thread_scopes,
)
from torcheval_tpu_torch.analysis.report import Finding, Report

__all__ = [
    "LockKey",
    "Universe",
    "build_universe",
    "check_locks",
    "iter_py_files",
]

LockKey = Tuple[str, str]  # (module dotted name, "Class.attr" | "GLOBAL")

# constructor types whose instances are safe to mutate without the
# owner's lock (self-synchronized, or thread-local by construction)
_EXEMPT_TYPES = _LOCK_TYPES | frozenset(
    {
        "local",
        "Event",
        "Thread",
        "Queue",
        "SimpleQueue",
        "LifoQueue",
        "PriorityQueue",
        "MappingProxyType",
    }
)
_MUTATORS = frozenset(
    {
        "add",
        "append",
        "appendleft",
        "clear",
        "discard",
        "extend",
        "insert",
        "pop",
        "popitem",
        "remove",
        "setdefault",
        "sort",
        "update",
    }
)
# attribute-call names that block the calling thread
_BLOCKING_METHODS = frozenset({"wait", "wait_for", "join", "acquire"})
# the port's ProcessGroup surface, the torch.distributed spellings its
# groups and the device paths call, and parallel/'s axis collectives
_COLLECTIVE_METHODS = frozenset(
    {
        "allgather_object",
        "allgather_array",
        "allgather_object_with_ranks",
        "allgather_array_with_ranks",
        "all_reduce",
        "all_gather",
        "all_gather_object",
        "broadcast",
        "barrier",
        "all_to_all_single",
        "batch_isend_irecv",
        "psum",
        "ppermute",
        "all_to_all",
    }
)
# module-level callables that block (time.sleep / from time import sleep;
# bounded_call parks on the deadline worker's done event)
_BLOCKING_FUNCTIONS = frozenset({"sleep", "bounded_call"})
# referencing any of these names routes the function through the
# per-caller-thread in-flight collective fence (resilience.py) — its
# collective sites are fence-protected by construction
FENCE_NAMES = frozenset(
    {"_tls_state", "_still_in_flight", "_get_worker", "_reclaim_finished"}
)
_INIT_METHODS = ("__init__", "__post_init__")


def _known_rule_ids() -> set:
    """Concurrency + lint rule ids — a mixed suppression line like
    ``disable=host-sync,guarded-field`` must not read as a typo to the
    fail-closed parser just because half of it targets the other tool.
    Lazy import: lint never imports this module, so no cycle."""
    from torcheval_tpu_torch.analysis.lint import RULES

    return set(RULES) | set(CONCURRENCY_RULE_IDS)


# the package roots a module name is taken from, the port's first: a
# file is named from the last of these directories on its path, so a port
# file and its JAX twin keep distinct names and no two files of one
# package share one
_PACKAGE_ROOTS = ("torcheval_tpu_torch/", "torcheval_tpu/")


def _package_root_index(norm: str) -> int:
    """Where the innermost package root starts in ``norm`` (-1: none)."""
    best = -1
    for root in _PACKAGE_ROOTS:
        idx = norm.rfind(root)
        if idx >= 0 and (idx == 0 or norm[idx - 1] == "/") and idx > best:
            best = idx
    return best


def _module_name(path: str) -> str:
    norm = os.path.abspath(path).replace(os.sep, "/")
    idx = _package_root_index(norm)
    if idx >= 0:
        rel = norm[idx:]
    else:
        rel = os.path.basename(norm)
    if rel.endswith(".py"):
        rel = rel[:-3]
    if rel.endswith("/__init__"):
        rel = rel[: -len("/__init__")]
    return rel.replace("/", ".")


def _call_name(node: ast.AST) -> str:
    """Terminal name of a Call's func (``threading.Lock`` -> ``Lock``)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _ctor_exempt(value: ast.AST) -> bool:
    """Constructed state that never needs a guarded-by binding."""
    if isinstance(value, ast.Call):
        return _call_name(value.func) in _EXEMPT_TYPES
    return False


def _expr_terminal(node: ast.AST) -> str:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _lockish(node: ast.AST) -> bool:
    """Heuristic: does this with-context expression LOOK like a lock?
    (Unresolvable lock-shaped acquisitions still count as "a lock is
    held" for blocking-under-lock, but match no guarded binding.)"""
    term = _expr_terminal(node).lower()
    return "lock" in term or term in ("mutex", "cond", "condition")


class _ClassModel:
    __slots__ = (
        "name",
        "node",
        "locks",
        "bindings",
        "exempt",
        "defined",
        "mutated",
        "methods",
    )

    def __init__(self, name: str, node: ast.ClassDef) -> None:
        self.name = name
        self.node = node
        self.locks: Dict[str, int] = {}  # attr -> line of construction
        self.bindings: Dict[str, Tuple[str, int]] = {}  # attr -> (lock, line)
        self.exempt: Set[str] = set()  # ctor-exempt attrs
        self.defined: Dict[str, int] = {}  # attr -> definition line
        self.mutated: Dict[str, int] = {}  # attr -> first out-of-init mutation
        self.methods: Dict[str, ast.AST] = {}


class _FunctionInfo:
    __slots__ = (
        "module",
        "qual",
        "cls",
        "node",
        "line",
        "thread_scope",
        "calls",
        "with_sites",
        "direct_edges",
        "blocking",
        "collectives",
        "fenced",
        "nested",
    )

    def __init__(self, module: str, qual: str, cls: Optional[str], node) -> None:
        self.module = module
        self.qual = qual
        self.cls = cls
        self.node = node
        self.line = node.lineno
        self.thread_scope: Optional[str] = None
        # filled by Universe._analyze_function:
        self.calls: List[Tuple[Any, int, Tuple]] = []  # (ref, line, held)
        self.with_sites: List[Tuple[LockKey, int]] = []
        self.direct_edges: List[Tuple[LockKey, int, LockKey, int]] = []
        self.blocking: List[Tuple[int, str]] = []  # lexical blocking calls
        self.collectives: List[Tuple[int, str]] = []
        self.fenced = False
        self.nested: Dict[str, "_FunctionInfo"] = {}


class _ModuleModel:
    """One parsed file: classes, locks, bindings, imports, functions."""

    def __init__(self, path: str, tree: ast.Module, lines: List[str]) -> None:
        self.path = path
        self.name = _module_name(path)
        self.tree = tree
        self.lines = lines
        self.suppressions, _ = parse_suppressions(lines, _known_rule_ids())
        self.guarded = parse_guarded_lines(lines)
        self.thread_scopes = parse_thread_scopes(lines)
        self.classes: Dict[str, _ClassModel] = {}
        self.mod_locks: Dict[str, int] = {}
        self.mod_bindings: Dict[str, Tuple[str, int]] = {}
        self.mod_globals: Dict[str, int] = {}  # top-level assigned names
        self.mod_exempt: Set[str] = set()
        self.functions: Dict[str, _FunctionInfo] = {}
        self.from_imports: Dict[str, Tuple[str, str]] = {}
        self.mod_aliases: Dict[str, str] = {}
        self.instances: Dict[str, str] = {}  # global -> class name (local ref)
        self.thread_targets: List[Tuple[ast.AST, int]] = []
        self._parse()

    # ----------------------------------------------------------- parsing

    def _parse(self) -> None:
        for node in self.tree.body:
            if isinstance(node, ast.ClassDef):
                self._parse_class(node)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions[node.name] = _FunctionInfo(
                    self.name, node.name, None, node
                )
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    self.mod_aliases[alias.asname or alias.name] = alias.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                for alias in node.names:
                    self.from_imports[alias.asname or alias.name] = (
                        node.module,
                        alias.name,
                    )
            elif isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                self._parse_global_assign(node)
        for fn in list(self.functions.values()):
            self._collect_nested(fn)
        for fn in self.all_functions():
            scope = self.thread_scopes.get(fn.node.lineno)
            if scope is not None:
                fn.thread_scope = scope
        for node in ast.walk(self.tree):
            if (
                isinstance(node, ast.Call)
                and _call_name(node.func) == "Thread"
            ):
                for kw in node.keywords:
                    if kw.arg == "target":
                        self.thread_targets.append((kw.value, node.lineno))

    def _collect_nested(self, fn: _FunctionInfo) -> None:
        for node in ast.walk(fn.node):
            if node is fn.node:
                continue
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                sub = _FunctionInfo(
                    self.name, f"{fn.qual}.{node.name}", fn.cls, node
                )
                fn.nested[node.name] = sub

    def _parse_global_assign(self, node) -> None:
        targets = (
            node.targets
            if isinstance(node, ast.Assign)
            else [node.target]
        )
        value = getattr(node, "value", None)
        for target in targets:
            if not isinstance(target, ast.Name):
                continue
            name = target.id
            self.mod_globals.setdefault(name, node.lineno)
            if value is not None and _lock_ctor_kind(value) is not None:
                self.mod_locks[name] = node.lineno
            if value is not None and _ctor_exempt(value):
                self.mod_exempt.add(name)
            lock = self.guarded.get(node.lineno)
            if lock is not None:
                self.mod_bindings[name] = (lock, node.lineno)
            # `_G: Optional[ClassName] = None` — instance-type annotation
            if isinstance(node, ast.AnnAssign):
                cls = self._annotation_class(node.annotation)
                if cls is not None:
                    self.instances[name] = cls
            elif (
                isinstance(value, ast.Call)
                and isinstance(value.func, ast.Name)
            ):
                self.instances.setdefault(name, value.func.id)

    def _annotation_class(self, node) -> Optional[str]:
        if isinstance(node, ast.Name):
            return node.id
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value.strip().split("[")[-1].rstrip("]") or None
        if isinstance(node, ast.Subscript) and _expr_terminal(
            node.value
        ) in ("Optional", "Final", "ClassVar"):
            return self._annotation_class(node.slice)
        if isinstance(node, ast.Attribute):
            return node.attr
        return None

    def _parse_class(self, node: ast.ClassDef) -> None:
        cm = _ClassModel(node.name, node)
        self.classes[node.name] = cm
        for stmt in node.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                cm.methods[stmt.name] = stmt
                qual = f"{node.name}.{stmt.name}"
                self.functions[qual] = _FunctionInfo(
                    self.name, qual, node.name, stmt
                )
            elif isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                targets = (
                    stmt.targets
                    if isinstance(stmt, ast.Assign)
                    else [stmt.target]
                )
                value = getattr(stmt, "value", None)
                for target in targets:
                    if not isinstance(target, ast.Name):
                        continue
                    attr = target.id
                    cm.defined.setdefault(attr, stmt.lineno)
                    if value is not None and _lock_ctor_kind(value):
                        cm.locks[attr] = stmt.lineno
                    if value is not None and _ctor_exempt(value):
                        cm.exempt.add(attr)
                    lock = self.guarded.get(stmt.lineno)
                    if lock is not None:
                        cm.bindings[attr] = (lock, stmt.lineno)
        # __init__ / __post_init__ self-attribute definitions
        for init_name in _INIT_METHODS:
            init = cm.methods.get(init_name)
            if init is None:
                continue
            for sub in ast.walk(init):
                if isinstance(sub, (ast.Assign, ast.AnnAssign)):
                    targets = (
                        sub.targets
                        if isinstance(sub, ast.Assign)
                        else [sub.target]
                    )
                    value = getattr(sub, "value", None)
                    for target in targets:
                        attr = _self_attr(target)
                        if attr is None:
                            continue
                        cm.defined.setdefault(attr, sub.lineno)
                        if value is not None and _lock_ctor_kind(value):
                            cm.locks.setdefault(attr, sub.lineno)
                        if value is not None and _ctor_exempt(value):
                            cm.exempt.add(attr)
                        lock = self.guarded.get(sub.lineno)
                        if lock is not None:
                            cm.bindings.setdefault(attr, (lock, sub.lineno))
        # out-of-init mutation census
        for mname, mnode in cm.methods.items():
            if mname in _INIT_METHODS:
                continue
            for attr, line in _self_mutations(mnode):
                if attr in cm.locks or attr in cm.exempt:
                    continue
                prev = cm.mutated.get(attr)
                if prev is None or line < prev:
                    cm.mutated[attr] = line
    def all_functions(self) -> Iterable[_FunctionInfo]:
        for fn in self.functions.values():
            yield fn
            yield from fn.nested.values()


def _self_attr(node) -> Optional[str]:
    """``self.x`` (or the ``self.x`` inside ``self.x[...]``) -> ``x``."""
    if isinstance(node, ast.Subscript):
        node = node.value
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _self_mutations(fn_node) -> Iterable[Tuple[str, int]]:
    """(attr, line) for every ``self.x`` write / in-place mutation."""
    for node in ast.walk(fn_node):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (
                node.targets if isinstance(node, ast.Assign) else [node.target]
            )
            for target in targets:
                if isinstance(target, ast.Tuple):
                    elts = target.elts
                else:
                    elts = [target]
                for elt in elts:
                    attr = _self_attr(elt)
                    if attr is not None:
                        yield attr, node.lineno
        elif isinstance(node, ast.Call) and isinstance(
            node.func, ast.Attribute
        ):
            if node.func.attr in _MUTATORS:
                attr = _self_attr(node.func.value)
                if attr is not None:
                    yield attr, node.lineno


def iter_py_files(paths: Iterable[str]) -> Iterable[str]:
    """Every ``.py`` under files/directories, sorted (the lint walk)."""
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


class Universe:
    """All swept modules plus name-based call/lock resolution — shared
    by the lock-discipline passes here and the thread/collective hazard
    model in ``analysis/concurrency.py``."""

    def __init__(self) -> None:
        self.modules: Dict[str, _ModuleModel] = {}
        self.parse_failures: List[Tuple[str, int, str]] = []

    # ---------------------------------------------------------- loading

    def add_file(self, path: str) -> None:
        try:
            with open(path, "r", encoding="utf-8") as f:
                source = f.read()
            tree = ast.parse(source, filename=path)
        except (OSError, UnicodeDecodeError) as e:
            self.parse_failures.append((path, 0, f"unreadable: {e}"))
            return
        except SyntaxError as e:
            self.parse_failures.append(
                (path, e.lineno or 0, f"syntax error: {e.msg}")
            )
            return
        model = _ModuleModel(path, tree, source.splitlines())
        self.modules[model.name] = model

    def analyze(self) -> None:
        for module in self.modules.values():
            for fn in module.all_functions():
                self._analyze_function(module, fn)

    # -------------------------------------------------------- resolution

    def _module_of(self, dotted: str) -> Optional[_ModuleModel]:
        if dotted in self.modules:
            return self.modules[dotted]
        # a from-import of a symbol re-exported by a package __init__
        # (e.g. `from torcheval_tpu_torch.obs import flight`) resolves the
        # submodule by suffix
        for name, model in self.modules.items():
            if name.endswith("." + dotted.rsplit(".", 1)[-1]):
                if dotted in name or name.endswith(dotted):
                    return model
        return None

    def _resolve_class(
        self, module: _ModuleModel, cls_name: str
    ) -> Optional[Tuple[_ModuleModel, _ClassModel]]:
        cm = module.classes.get(cls_name)
        if cm is not None:
            return module, cm
        imported = module.from_imports.get(cls_name)
        if imported is not None:
            target = self._module_of(imported[0])
            if target is not None:
                cm = target.classes.get(imported[1])
                if cm is not None:
                    return target, cm
        return None

    def _instance_class(
        self, module: _ModuleModel, name: str
    ) -> Optional[Tuple[_ModuleModel, _ClassModel]]:
        cls_name = module.instances.get(name)
        if cls_name is None:
            return None
        return self._resolve_class(module, cls_name)

    def _resolve_imported_module(
        self, module: _ModuleModel, name: str
    ) -> Optional[_ModuleModel]:
        if name in module.mod_aliases:
            return self._module_of(module.mod_aliases[name])
        imported = module.from_imports.get(name)
        if imported is not None:
            # `from torcheval_tpu_torch.obs import flight as _flight`
            return self._module_of(f"{imported[0]}.{imported[1]}")
        return None

    def resolve_lock_expr(
        self,
        expr: ast.AST,
        module: _ModuleModel,
        cls: Optional[str],
        local_types: Dict[str, str],
    ) -> Optional[LockKey]:
        if isinstance(expr, ast.Name):
            if expr.id in module.mod_locks:
                return (module.name, expr.id)
            imported = module.from_imports.get(expr.id)
            if imported is not None:
                target = self._module_of(imported[0])
                if target is not None and imported[1] in target.mod_locks:
                    return (target.name, imported[1])
            return None
        if not isinstance(expr, ast.Attribute):
            return None
        base = expr.value
        if isinstance(base, ast.Name):
            if base.id == "self" and cls is not None:
                cm = module.classes.get(cls)
                if cm is not None and expr.attr in cm.locks:
                    return (module.name, f"{cls}.{expr.attr}")
                return None
            target = self._resolve_imported_module(module, base.id)
            if target is not None and expr.attr in target.mod_locks:
                return (target.name, expr.attr)
            inst = self._instance_class(
                module, local_types.get(base.id, "")
            ) or self._instance_class(module, base.id)
            if inst is None and base.id in local_types:
                inst = self._resolve_class(module, local_types[base.id])
            if inst is not None and expr.attr in inst[1].locks:
                return (inst[0].name, f"{inst[1].name}.{expr.attr}")
        elif isinstance(base, ast.Attribute) and isinstance(
            base.value, ast.Name
        ):
            # `_mod.GLOBAL.lock` — module alias, global instance, attr
            target = self._resolve_imported_module(module, base.value.id)
            if target is not None:
                inst = self._instance_class(target, base.attr)
                if inst is not None and expr.attr in inst[1].locks:
                    return (inst[0].name, f"{inst[1].name}.{expr.attr}")
        return None

    def resolve_call(
        self,
        func: ast.AST,
        module: _ModuleModel,
        fn: _FunctionInfo,
        local_types: Dict[str, str],
    ) -> Optional[_FunctionInfo]:
        """A call expression -> the _FunctionInfo it targets, when the
        name-based rules can tell; None for dynamic/foreign calls."""
        if isinstance(func, ast.Name):
            name = func.id
            if name in fn.nested:
                return fn.nested[name]
            if name in module.functions:
                return module.functions[name]
            imported = module.from_imports.get(name)
            if imported is not None:
                target = self._module_of(imported[0])
                if target is not None and imported[1] in target.functions:
                    return target.functions[imported[1]]
            return None
        if not isinstance(func, ast.Attribute):
            return None
        base = func.value
        attr = func.attr
        if isinstance(base, ast.Name):
            if base.id == "self" and fn.cls is not None:
                qual = f"{fn.cls}.{attr}"
                if qual in module.functions:
                    return module.functions[qual]
                # bound-callback fallback: exactly one class in this
                # module defines the method (`self._write_bundle` handed
                # to a writer class as a callback)
                hits = [
                    f
                    for q, f in module.functions.items()
                    if q.endswith("." + attr)
                ]
                if len(hits) == 1:
                    return hits[0]
                return None
            target = self._resolve_imported_module(module, base.id)
            if target is not None and attr in target.functions:
                return target.functions[attr]
            cls_name = local_types.get(base.id) or module.instances.get(
                base.id
            )
            if cls_name is not None:
                resolved = self._resolve_class(module, cls_name)
                if resolved is not None:
                    target_mod, cm = resolved
                    qual = f"{cm.name}.{attr}"
                    return target_mod.functions.get(qual)
        elif isinstance(base, ast.Attribute) and isinstance(
            base.value, ast.Name
        ):
            target = self._resolve_imported_module(module, base.value.id)
            if target is not None:
                cls_name = target.instances.get(base.attr)
                if cls_name is not None:
                    resolved = self._resolve_class(target, cls_name)
                    if resolved is not None:
                        target_mod, cm = resolved
                        return target_mod.functions.get(f"{cm.name}.{attr}")
        return None

    # ----------------------------------------------- per-function analysis

    def _analyze_function(
        self, module: _ModuleModel, fn: _FunctionInfo
    ) -> None:
        local_types: Dict[str, str] = {}
        args_node = fn.node.args
        for arg in (
            list(args_node.posonlyargs)
            + list(args_node.args)
            + list(args_node.kwonlyargs)
        ):
            if arg.annotation is not None:
                cls = module._annotation_class(arg.annotation)
                if cls is not None:
                    local_types.setdefault(arg.arg, cls)
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                target = node.targets[0]
                if isinstance(target, ast.Name) and isinstance(
                    node.value, ast.Call
                ):
                    ctor = node.value.func
                    if isinstance(ctor, ast.Name):
                        local_types.setdefault(target.id, ctor.id)
            if isinstance(node, ast.Name) and node.id in FENCE_NAMES:
                fn.fenced = True
            if isinstance(node, ast.Call):
                cattr = _call_name(node.func)
                if cattr in FENCE_NAMES:
                    fn.fenced = True

        nested_nodes = {sub.node for sub in fn.nested.values()}

        def visit(node, held: Tuple[Tuple[Optional[LockKey], ast.AST, int], ...]):
            if node in nested_nodes:
                return  # analyzed as its own function
            if isinstance(node, ast.With):
                new_held = held
                for item in node.items:
                    expr = item.context_expr
                    key = self.resolve_lock_expr(
                        expr, module, fn.cls, local_types
                    )
                    if key is not None or _lockish(expr):
                        if key is not None:
                            fn.with_sites.append((key, node.lineno))
                            # order edges against everything already
                            # held — including EARLIER ITEMS of this
                            # same statement (`with A, B:` acquires A
                            # then B, exactly like nested withs)
                            for outer_key, _, outer_line in new_held:
                                if outer_key is not None:
                                    fn.direct_edges.append(
                                        (
                                            outer_key,
                                            outer_line,
                                            key,
                                            node.lineno,
                                        )
                                    )
                        new_held = new_held + ((key, expr, node.lineno),)
                for child in node.body:
                    visit(child, new_held)
                return
            if isinstance(node, ast.Call):
                self._note_call(module, fn, node, held, local_types)
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        for stmt in fn.node.body:
            visit(stmt, ())

    def _note_call(
        self,
        module: _ModuleModel,
        fn: _FunctionInfo,
        node: ast.Call,
        held,
        local_types,
    ) -> None:
        name = _call_name(node.func)
        blocking: Optional[str] = None
        if name in _COLLECTIVE_METHODS:
            fn.collectives.append((node.lineno, name))
            blocking = f"collective `{name}`"
        elif isinstance(node.func, ast.Attribute):
            if name in _BLOCKING_METHODS:
                receiver = ast.dump(node.func.value)
                held_exprs = {ast.dump(e) for _, e, _ in held}
                term = _expr_terminal(node.func.value).lower()
                if name in ("wait", "wait_for") and receiver in held_exprs:
                    blocking = None  # Condition.wait on the held lock
                elif name == "join" and not (
                    term == "_q"
                    or any(
                        hint in term
                        for hint in ("thread", "proc", "worker", "queue", "jobs")
                    )
                ):
                    blocking = None  # str.join / os.path.join, not a thread
                else:
                    blocking = f"`.{name}()`"
            elif name == "get" and not node.args and not node.keywords:
                blocking = "`.get()` (queue hand-off)"
            elif name == "sleep" and _expr_terminal(node.func.value) == "time":
                blocking = "`time.sleep`"
        elif isinstance(node.func, ast.Name) and name in _BLOCKING_FUNCTIONS:
            blocking = f"`{name}()`"
        if blocking is not None:
            fn.blocking.append((node.lineno, blocking))
            if held:
                lock_desc = _expr_terminal(held[-1][1]) or "a lock"
                fn.blocking[-1] = (
                    node.lineno,
                    f"{blocking} while holding `{lock_desc}` "
                    f"(acquired line {held[-1][2]})",
                )
        callee = self.resolve_call(node.func, module, fn, local_types)
        fn.calls.append((callee, node.lineno, held))

    # ------------------------------------------------------- pass: discipline

    def discipline_findings(self) -> List[Finding]:
        findings: List[Finding] = []
        for module in self.modules.values():
            findings.extend(self._module_discipline(module))
        return findings

    def _emit(
        self,
        module: _ModuleModel,
        rule: str,
        line: int,
        message: str,
        severity: str = "error",
    ) -> Finding:
        suppressed = False
        reason = ""
        entry = module.suppressions.get(line)
        if entry is not None and rule in entry[0]:
            suppressed = True
            reason = entry[1]
        return Finding(
            tool="concurrency",
            rule=rule,
            path=module.path,
            line=line,
            message=message,
            severity=severity,
            suppressed=suppressed,
            suppress_reason=reason,
        )

    def _binding_key(
        self, module: _ModuleModel, cls: Optional[_ClassModel], lock: str
    ) -> Optional[LockKey]:
        if cls is not None and lock in cls.locks:
            return (module.name, f"{cls.name}.{lock}")
        if lock in module.mod_locks:
            return (module.name, lock)
        return None

    def _module_discipline(self, module: _ModuleModel) -> List[Finding]:
        findings: List[Finding] = []
        # --- classes -------------------------------------------------
        for cm in module.classes.values():
            for attr, (lock, line) in sorted(cm.bindings.items()):
                if self._binding_key(module, cm, lock) is None:
                    findings.append(
                        self._emit(
                            module,
                            "bad-annotation",
                            line,
                            f"guarded-by names unknown lock `{lock}` "
                            f"(class {cm.name} locks: "
                            f"{sorted(cm.locks) or 'none'}; module locks: "
                            f"{sorted(module.mod_locks) or 'none'})",
                        )
                    )
            if cm.locks:
                for attr, mline in sorted(cm.mutated.items()):
                    if attr in cm.bindings:
                        continue
                    line = cm.defined.get(attr, mline)
                    findings.append(
                        self._emit(
                            module,
                            "unguarded-state",
                            line,
                            f"`{cm.name}.{attr}` is mutated outside "
                            f"__init__ (line {mline}) in a lock-owning "
                            f"class with no `# tev: guarded-by=` binding "
                            f"(locks here: {sorted(cm.locks)}); bind it, "
                            "or exempt with `# tev: "
                            "disable=unguarded-state -- <reason>`",
                        )
                    )
        # --- module globals ------------------------------------------
        for name, (lock, line) in sorted(module.mod_bindings.items()):
            if lock not in module.mod_locks:
                findings.append(
                    self._emit(
                        module,
                        "bad-annotation",
                        line,
                        f"guarded-by names unknown module lock `{lock}` "
                        f"(module locks: {sorted(module.mod_locks) or 'none'})",
                    )
                )
        if module.mod_locks:
            mutated = self._global_mutations(module)
            for name, mline in sorted(mutated.items()):
                if (
                    name in module.mod_bindings
                    or name in module.mod_locks
                    or name in module.mod_exempt
                ):
                    continue
                line = module.mod_globals.get(name, mline)
                findings.append(
                    self._emit(
                        module,
                        "unguarded-state",
                        line,
                        f"module global `{name}` is mutated by functions "
                        "in a lock-owning module with no `# tev: "
                        "guarded-by=` binding (locks here: "
                        f"{sorted(module.mod_locks)}); bind it, or exempt "
                        "with `# tev: disable=unguarded-state -- <reason>`",
                    )
                )
        # --- guarded-field + blocking-under-lock ----------------------
        # blocking sites are per-function (each _FunctionInfo records its
        # own lexical holds); the guarded-field walk runs on TOP-LEVEL
        # functions/methods only and descends into nested defs carrying
        # the enclosing lexical lock context — a closure running under
        # its parent's `with` must not re-check lock-free
        for fn in module.all_functions():
            findings.extend(self._function_discipline(module, fn, fields=False))
        for fn in module.functions.values():
            findings.extend(self._function_discipline(module, fn, fields=True))
        return findings

    def _global_mutations(self, module: _ModuleModel) -> Dict[str, int]:
        mutated: Dict[str, int] = {}
        for fn in module.all_functions():
            declared_global: Set[str] = set()
            local_names: Set[str] = set()
            for node in ast.walk(fn.node):
                if isinstance(node, ast.Global):
                    declared_global.update(node.names)
            for node in ast.walk(fn.node):
                if isinstance(node, ast.Name) and isinstance(
                    node.ctx, ast.Store
                ):
                    if node.id not in declared_global:
                        local_names.add(node.id)
            for node in ast.walk(fn.node):
                hits: List[Tuple[str, int]] = []
                if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                    targets = (
                        node.targets
                        if isinstance(node, ast.Assign)
                        else [node.target]
                    )
                    for target in targets:
                        if (
                            isinstance(target, ast.Name)
                            and target.id in declared_global
                        ):
                            hits.append((target.id, node.lineno))
                        elif isinstance(target, ast.Subscript) and isinstance(
                            target.value, ast.Name
                        ):
                            hits.append((target.value.id, node.lineno))
                elif isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute
                ):
                    if node.func.attr in _MUTATORS and isinstance(
                        node.func.value, ast.Name
                    ):
                        hits.append((node.func.value.id, node.lineno))
                for name, line in hits:
                    if (
                        name in module.mod_globals
                        and name not in local_names
                    ):
                        prev = mutated.get(name)
                        if prev is None or line < prev:
                            mutated[name] = line
        return mutated

    def _function_discipline(
        self, module: _ModuleModel, fn: _FunctionInfo, *, fields: bool
    ) -> List[Finding]:
        findings: List[Finding] = []
        method_name = fn.qual.rsplit(".", 1)[-1]
        if method_name in _INIT_METHODS:
            return findings
        cm = module.classes.get(fn.cls) if fn.cls else None
        if fields:
            return self._guarded_field_walk(module, fn, cm)
        # blocking-under-lock: lexical sites already carry their message
        for line, message in fn.blocking:
            if "while holding" in message:
                findings.append(
                    self._emit(
                        module,
                        "blocking-under-lock",
                        line,
                        f"{message} — a blocked holder convoys every "
                        "contender (and deadlocks if the unblocker needs "
                        "this lock)",
                    )
                )
        # one-level interprocedural: a call made under a lock into a
        # function that lexically blocks
        for callee, line, held in fn.calls:
            if callee is None or not held:
                continue
            if callee.blocking:
                bline, bwhat = callee.blocking[0]
                lock_desc = _expr_terminal(held[-1][1]) or "a lock"
                findings.append(
                    self._emit(
                        module,
                        "blocking-under-lock",
                        line,
                        f"call to `{callee.qual}` while holding "
                        f"`{lock_desc}` (acquired line {held[-1][2]}) — "
                        f"the callee blocks ({bwhat.split(' while ')[0]} "
                        f"at {os.path.basename(callee.module)}:{bline})",
                    )
                )
        return findings

    def _guarded_field_walk(
        self,
        module: _ModuleModel,
        fn: _FunctionInfo,
        cm: Optional[_ClassModel],
    ) -> List[Finding]:
        """Enforce guarded-by bindings over one top-level function or
        method, descending into nested defs WITH the enclosing lexical
        lock context (a closure under its parent's ``with`` is held)."""
        findings: List[Finding] = []
        local_types: Dict[str, str] = {}

        def required_key(lock: str) -> Optional[LockKey]:
            return self._binding_key(module, cm, lock)

        nested_nodes = {sub.node for sub in fn.nested.values()}
        declared_global: Set[str] = set()
        local_names: Set[str] = set()
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Global):
                declared_global.update(node.names)
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
                if node.id not in declared_global:
                    local_names.add(node.id)

        seen: Set[Tuple[str, int]] = set()

        def visit(node, held_keys: frozenset):
            if node in nested_nodes:
                pass  # nested defs inherit the lexical lock scope
            if isinstance(node, ast.With):
                new_keys = held_keys
                for item in node.items:
                    key = self.resolve_lock_expr(
                        item.context_expr, module, fn.cls, local_types
                    )
                    if key is not None:
                        new_keys = new_keys | {key}
                for child in node.body:
                    visit(child, new_keys)
                return
            attr = None
            scope = ""
            binding = None
            bind_line = 0
            if isinstance(node, ast.Attribute) and isinstance(
                node.value, ast.Name
            ):
                if node.value.id == "self" and cm is not None:
                    attr = node.attr
                    entry = cm.bindings.get(attr)
                    if entry is not None:
                        binding, bind_line = entry
                        scope = f"{cm.name}.{attr}"
            elif isinstance(node, ast.Name):
                entry = module.mod_bindings.get(node.id)
                if (
                    entry is not None
                    and node.id not in local_names
                ):
                    attr = node.id
                    binding, bind_line = entry
                    scope = attr
            if binding is not None and node.lineno != bind_line:
                key = required_key(binding)
                if key is not None and key not in held_keys:
                    mark = (scope, node.lineno)
                    if mark not in seen:
                        seen.add(mark)
                        findings.append(
                            self._emit(
                                module,
                                "guarded-field",
                                node.lineno,
                                f"`{scope}` is bound to `{binding}` "
                                f"(guarded-by, line {bind_line}) but is "
                                "read/written here outside any "
                                f"`with {binding}` scope",
                            )
                        )
            for child in ast.iter_child_nodes(node):
                visit(child, held_keys)

        for stmt in fn.node.body:
            visit(stmt, frozenset())
        return findings

    # ------------------------------------------------------- pass: lock order

    def lock_order_findings(self) -> List[Finding]:
        # transitively-acquired locks per function, with one witness
        # chain per (function, lock)
        acquired: Dict[Tuple[str, str], Dict[LockKey, List[str]]] = {}

        def site(fn: _FunctionInfo, line: int) -> str:
            return f"{os.path.basename(fn.module)}:{line} ({fn.qual})"

        def compute(fn: _FunctionInfo, stack: Set[Tuple[str, str]]):
            key = (fn.module, fn.qual)
            if key in acquired:
                return acquired[key]
            if key in stack:
                return {}
            stack = stack | {key}
            out: Dict[LockKey, List[str]] = {}
            for lock, line in fn.with_sites:
                out.setdefault(lock, [site(fn, line)])
            for callee, line, _held in fn.calls:
                if callee is None:
                    continue
                for lock, chain in compute(callee, stack).items():
                    out.setdefault(lock, [site(fn, line)] + chain)
            acquired[key] = out
            return out

        edges: Dict[LockKey, Dict[LockKey, List[str]]] = {}

        def add_edge(a: LockKey, b: LockKey, chain: List[str]) -> None:
            if a == b:
                return
            edges.setdefault(a, {}).setdefault(b, chain)

        for module in self.modules.values():
            for fn in module.all_functions():
                compute(fn, set())
                for outer, oline, inner, iline in fn.direct_edges:
                    add_edge(
                        outer,
                        inner,
                        [site(fn, oline), site(fn, iline)],
                    )
                for callee, line, held in fn.calls:
                    if callee is None:
                        continue
                    inner_locks = compute(callee, set())
                    for _hkey, _hexpr, hline in held:
                        if _hkey is None:
                            continue
                        for lock, chain in inner_locks.items():
                            add_edge(
                                _hkey,
                                lock,
                                [site(fn, hline), site(fn, line)] + chain,
                            )

        findings: List[Finding] = []
        reported: Set[Tuple[LockKey, ...]] = set()
        for start in sorted(edges):
            cycle = self._find_cycle(edges, start)
            if cycle is None:
                continue
            canon_idx = cycle.index(min(cycle))
            canon = tuple(cycle[canon_idx:] + cycle[:canon_idx])
            if canon in reported:
                continue
            reported.add(canon)
            parts = []
            for i, a in enumerate(cycle):
                b = cycle[(i + 1) % len(cycle)]
                chain = edges[a][b]
                parts.append(
                    f"{a[1]} -> {b[1]} (acquired via: "
                    + " -> ".join(chain)
                    + ")"
                )
            first_a, first_b = cycle[0], cycle[1 % len(cycle)]
            first_chain = edges[first_a][first_b]
            module, line = self._site_location(first_chain[0])
            finding = Finding(
                tool="concurrency",
                rule="lock-order-cycle",
                path=module.path if module else first_chain[0],
                line=line,
                message=(
                    "lock-order cycle (would-deadlock: two threads "
                    "entering from different edges wait on each other "
                    "forever): " + "; ".join(parts)
                ),
            )
            if module is not None:
                entry = module.suppressions.get(line)
                if entry is not None and "lock-order-cycle" in entry[0]:
                    finding.suppressed = True
                    finding.suppress_reason = entry[1]
            findings.append(finding)
        return findings

    def _site_location(
        self, site: str
    ) -> Tuple[Optional[_ModuleModel], int]:
        # "module.py:123 (qual)" -> (_ModuleModel, 123)
        try:
            loc = site.split(" ")[0]
            fname, line_s = loc.rsplit(":", 1)
            line = int(line_s)
        except ValueError:
            return None, 0
        for module in self.modules.values():
            if os.path.basename(module.name) == fname or module.name.endswith(
                fname
            ):
                return module, line
        return None, line

    @staticmethod
    def _find_cycle(
        edges: Dict[LockKey, Dict[LockKey, List[str]]], start: LockKey
    ) -> Optional[List[LockKey]]:
        path: List[LockKey] = []
        on_path: Set[LockKey] = set()
        visited: Set[LockKey] = set()

        def dfs(node: LockKey) -> Optional[List[LockKey]]:
            if node in on_path:
                return path[path.index(node):]
            if node in visited:
                return None
            visited.add(node)
            path.append(node)
            on_path.add(node)
            for nxt in sorted(edges.get(node, {})):
                found = dfs(nxt)
                if found is not None:
                    return found
            path.pop()
            on_path.discard(node)
            return None

        return dfs(start)


def build_universe(paths: Iterable[str]) -> Universe:
    """Parse and analyze every ``.py`` under ``paths`` into a
    :class:`Universe` (the shared front half of ``check_locks`` and
    ``concurrency.check_concurrency``)."""
    universe = Universe()
    for path in iter_py_files(paths):
        universe.add_file(path)
    universe.analyze()
    return universe


def check_locks(
    paths: Iterable[str], *, universe: Optional[Universe] = None
) -> Report:
    """The lock-discipline + lock-order report over ``paths`` (or an
    already-built :class:`Universe`)."""
    if universe is None:
        universe = build_universe(paths)
    report = Report(tool="concurrency")
    report.checked = len(universe.modules)
    for path, line, message in universe.parse_failures:
        report.findings.append(
            Finding(
                tool="concurrency",
                rule="parse-error",
                path=path,
                line=line,
                message=message,
                severity="warning",
            )
        )
    report.findings.extend(universe.discipline_findings())
    report.findings.extend(universe.lock_order_findings())
    report.findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return report
