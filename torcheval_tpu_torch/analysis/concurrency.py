"""Thread/collective hazard model + the ``--concurrency`` driver.

The counterpart of ``torcheval_tpu/analysis/concurrency.py``. The
incident class, statically: the elastic async writer issued its
snapshot digest allgather on the same group the main thread was syncing
metrics on, so the two threads' collectives paired off in different
orders on different ranks — a cross-rank deadlock that only manifested
under load. Collectives are only safe when ONE thread context owns a
group's collective sequence; this pass proves that ownership:

- **Thread contexts.** Every ``threading.Thread(target=...)`` whose
  target resolves inside the swept universe is a thread ENTRY POINT and
  must carry a ``# tev: scope=worker|writer|watchdog|syncplane``
  annotation on its ``def`` line (``unannotated-thread-target``
  otherwise — the model must
  stay complete as threads are added). Everything reachable from an
  entry point (name-based call graph, ``analysis/locks.py`` resolution
  rules) runs in that context; everything reachable from an un-called
  public root runs in ``main``.
- **cross-thread-collective.** A collective issue
  (``allgather_object`` / ``allgather_array`` / ``*_with_ranks``)
  inside a function reachable from MORE THAN ONE thread context is a
  would-deadlock finding — unless the function routes through the
  per-caller-thread in-flight fence (``resilience._tls_state`` /
  ``_still_in_flight`` / ``_get_worker``), which serializes abandoned
  collectives per thread by construction. A site that is instead safe
  because it owns a DEDICATED communicator (the elastic writer's
  whole-world subgroup) documents that with a reasoned suppression.

``check_concurrency`` combines this pass with the lock-discipline and
lock-order passes (``analysis/locks.py``) into the one report
``python -m torcheval_tpu_torch.analysis --concurrency`` gates on; active
findings mirror into ``obs`` as ``AnalysisEvent``s via
``set_last_report`` like every analyzer layer. Stdlib-only: the
concurrency gate runs without torch.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Set, Tuple

from torcheval_tpu_torch.analysis.annotations import CONCURRENCY_RULE_IDS
from torcheval_tpu_torch.analysis.locks import (
    Universe,
    build_universe,
    check_locks,
)
from torcheval_tpu_torch.analysis.report import Finding, Report, set_last_report

__all__ = [
    "DEFAULT_TARGETS",
    "check_concurrency",
    "thread_contexts",
]

# The threaded modules that are the sweep floor -- the CLI
# default sweeps the whole package, a strict superset; these exist so
# tests can pin that the floor stays covered.
DEFAULT_TARGETS = (
    "obs",
    "resilience.py",
    "elastic.py",
    "failover.py",
    "federation.py",
    "streaming",
    "syncplane.py",
    "table",
    os.path.join("utils", "checkpoint.py"),
)


def _thread_entries(universe: Universe) -> Tuple[List, List[Finding]]:
    """Resolve every ``Thread(target=...)`` in the universe.

    Returns ``([(fn, context), ...], [unannotated findings])`` — targets
    that do not resolve inside the universe (stdlib callables like
    ``httpd.serve_forever``) are skipped: they cannot re-enter library
    code, so they cannot issue library collectives."""
    entries = []
    findings: List[Finding] = []
    for module in universe.modules.values():
        for target_expr, line in module.thread_targets:
            enclosing = None
            for fn in module.all_functions():
                node = fn.node
                if (
                    node.lineno <= line
                    and line <= max(
                        getattr(node, "end_lineno", node.lineno), node.lineno
                    )
                ):
                    if enclosing is None or node.lineno > enclosing.node.lineno:
                        enclosing = fn
            if enclosing is None:
                continue
            target = universe.resolve_call(target_expr, module, enclosing, {})
            if target is None:
                continue
            if target.thread_scope is None:
                finding = Finding(
                    tool="concurrency",
                    rule="unannotated-thread-target",
                    path=module.path,
                    line=line,
                    message=(
                        f"Thread target `{target.qual}` has no thread-"
                        "context annotation: add `# tev: scope=worker|"
                        "writer|watchdog|syncplane` on its def line so "
                        "the cross-thread collective model stays complete"
                    ),
                )
                entry = module.suppressions.get(line)
                if entry is not None and (
                    "unannotated-thread-target" in entry[0]
                ):
                    finding.suppressed = True
                    finding.suppress_reason = entry[1]
                findings.append(finding)
                continue
            entries.append((target, target.thread_scope))
    return entries, findings


def thread_contexts(
    universe: Universe, entries=None
) -> Dict[Tuple[str, str], Set[str]]:
    """``{(module, qual): {context, ...}}`` for every function in the
    universe: thread entries seed their annotated context, un-called
    roots seed ``main``, and contexts propagate along the resolved call
    graph. ``entries`` accepts an already-resolved ``_thread_entries``
    result so one sweep resolves every Thread target exactly once."""
    if entries is None:
        entries, _ = _thread_entries(universe)
    entry_keys = {(fn.module, fn.qual) for fn, _ in entries}
    called: Set[Tuple[str, str]] = set()
    for module in universe.modules.values():
        for fn in module.all_functions():
            for callee, _line, _held in fn.calls:
                if callee is not None:
                    called.add((callee.module, callee.qual))
    contexts: Dict[Tuple[str, str], Set[str]] = {}
    fn_index = {
        (fn.module, fn.qual): fn
        for module in universe.modules.values()
        for fn in module.all_functions()
    }

    def propagate(key: Tuple[str, str], context: str) -> None:
        stack = [key]
        while stack:
            current = stack.pop()
            bucket = contexts.setdefault(current, set())
            if context in bucket:
                continue
            bucket.add(context)
            fn = fn_index.get(current)
            if fn is None:
                continue
            for callee, _line, _held in fn.calls:
                if callee is not None:
                    stack.append((callee.module, callee.qual))

    for fn, context in entries:
        propagate((fn.module, fn.qual), context)
    for key, fn in fn_index.items():
        if key not in called and key not in entry_keys:
            propagate(key, "main")
    return contexts


def check_hazards(universe: Universe) -> Report:
    """The thread/collective hazard report over an analyzed universe."""
    report = Report(tool="concurrency")
    report.checked = len(universe.modules)
    entries, findings = _thread_entries(universe)
    report.findings.extend(findings)
    contexts = thread_contexts(universe, entries)
    for module in universe.modules.values():
        for fn in module.all_functions():
            if not fn.collectives:
                continue
            ctx = sorted(contexts.get((fn.module, fn.qual), {"main"}))
            if len(ctx) < 2:
                continue
            if fn.fenced:
                # routed through the per-caller-thread in-flight fence:
                # each thread's abandoned collectives serialize before a
                # new issue, the safe-by-construction multi-context shape
                continue
            for line, op in fn.collectives:
                finding = Finding(
                    tool="concurrency",
                    rule="cross-thread-collective",
                    path=module.path,
                    line=line,
                    message=(
                        f"collective `{op}` in `{fn.qual}` is reachable "
                        f"from thread contexts {ctx}: two threads "
                        "interleaving collectives on one group pair "
                        "them off in different orders on different "
                        "ranks (cross-rank deadlock). Route through the "
                        "per-thread in-flight fence, use a dedicated "
                        "communicator, or suppress with the reason that "
                        "makes this single-sequenced"
                    ),
                )
                entry = module.suppressions.get(line)
                if entry is not None and (
                    "cross-thread-collective" in entry[0]
                ):
                    finding.suppressed = True
                    finding.suppress_reason = entry[1]
                report.findings.append(finding)
    report.findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return report


def check_concurrency(
    paths: Iterable[str], *, record: bool = True
) -> Report:
    """The full concurrency verifier over ``paths``: lock discipline,
    lock-order cycles, blocking-under-lock, and the thread/collective
    hazard model, as ONE report (tool ``concurrency``). The recording
    entry point behind ``python -m torcheval_tpu_torch.analysis
    --concurrency``."""
    universe = build_universe(paths)
    combined = check_locks((), universe=universe)
    hazards = check_hazards(universe)
    combined.findings.extend(hazards.findings)
    # one checked-count, not two sweeps' worth
    combined.checked = len(universe.modules)
    combined.findings.sort(key=lambda f: (f.path, f.line, f.rule))
    assert {f.rule for f in combined.findings} <= (
        CONCURRENCY_RULE_IDS | {"parse-error"}
    ), "concurrency rule ids must stay registered in annotations.py"
    if record:
        set_last_report(combined)
    return combined
