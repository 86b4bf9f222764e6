"""Shared `# tev:` source-annotation grammar for the analyzer layers.

One comment grammar, parsed in one place, so the lint (``lint.py``) and
the concurrency verifier (``locks.py`` / ``concurrency.py``) cannot
drift apart on what a suppression or a binding looks like:

- ``# tev: disable=<rule>[,<rule>...] -- <reason>`` — per-line
  suppression. The reason is mandatory; a reasonless suppression is a
  ``bad-suppression`` finding and does NOT suppress (the underlying
  finding stays active, so a lazy suppression can never turn the gate
  green).
- ``# tev: scope=jit|host`` — file-level module classification (first
  lines; the lint's jit-reachability model).
- ``# tev: scope=worker|writer|watchdog|syncplane`` — on a ``def``
  line: the function is a background-THREAD entry point and everything
  reachable from it runs in that thread context (the concurrency hazard
  model).
- ``# tev: guarded-by=<lock>`` — on an attribute assignment (in
  ``__init__``, a dataclass field line, or a module-global assignment):
  the attribute is shared mutable state protected by ``<lock>`` (an
  attribute name of the same class, or a module-global lock name).
  Every later read/write of the attribute must sit inside a
  ``with <lock>`` scope.

The counterpart of ``torcheval_tpu/analysis/annotations.py``: the
grammar is shared, so one comment means the same to both packages'
analyzers. Stdlib-only by design (the concurrency gate runs without
torch, like the lint).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

__all__ = [
    "CONCURRENCY_RULE_IDS",
    "GUARDED_RE",
    "LOCK_TYPE_NAMES",
    "SUPPRESS_RE",
    "THREAD_SCOPES",
    "THREAD_SCOPE_RE",
    "lock_ctor_kind",
    "parse_guarded_lines",
    "parse_suppressions",
    "parse_thread_scopes",
]

# The one lock-constructor vocabulary shared by the lint's ``bare-lock``
# rule and the verifier's lock inventory (``analysis/locks.py``) — a
# type added here is seen by BOTH, so the two passes cannot drift.
LOCK_TYPE_NAMES = frozenset(
    {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}
)


def lock_ctor_kind(value: ast.AST) -> Optional[str]:
    """``threading.Lock()`` / ``field(default_factory=threading.Lock)``
    -> the lock type name, else ``None``."""
    if not isinstance(value, ast.Call):
        return None
    fn = value.func
    name = fn.attr if isinstance(fn, ast.Attribute) else (
        fn.id if isinstance(fn, ast.Name) else ""
    )
    if name in LOCK_TYPE_NAMES:
        return name
    if name == "field":
        for kw in value.keywords:
            if kw.arg == "default_factory":
                factory = kw.value
                fname = factory.attr if isinstance(
                    factory, ast.Attribute
                ) else (factory.id if isinstance(factory, ast.Name) else "")
                if fname in LOCK_TYPE_NAMES:
                    return fname
    return None

SUPPRESS_RE = re.compile(
    r"#\s*tev:\s*disable=([\w\-,]+)(?:\s*--\s*(.*\S))?\s*$"
)
GUARDED_RE = re.compile(r"#\s*tev:\s*guarded-by=([\w]+)\b")
THREAD_SCOPE_RE = re.compile(
    r"#\s*tev:\s*scope=(worker|writer|watchdog|syncplane)\b"
)

THREAD_SCOPES = ("worker", "writer", "watchdog", "syncplane")

# Rule ids of the concurrency verifier. Listed statically so the lint's suppression
# audit accepts them without importing the concurrency passes (a plain
# lint run must stay cheap), and so the verifier can assert it registers
# exactly these.
CONCURRENCY_RULE_IDS = frozenset(
    {
        "unguarded-state",
        "guarded-field",
        "lock-order-cycle",
        "blocking-under-lock",
        "cross-thread-collective",
        "unannotated-thread-target",
        "bad-annotation",
    }
)


def parse_suppressions(
    lines: List[str], known_ids: Iterable[str]
) -> Tuple[Dict[int, Tuple[Set[str], str]], List[Tuple[int, int, str]]]:
    """Per-line suppression map plus bad-suppression findings.

    Returns ``({line: ({rule_id, ...}, reason)}, [(line, col, message)])``
    — reasonless or unknown-rule suppressions land in the second list
    and do NOT enter the map (they suppress nothing)."""
    known = set(known_ids)
    suppressions: Dict[int, Tuple[Set[str], str]] = {}
    bad: List[Tuple[int, int, str]] = []
    for i, line in enumerate(lines, start=1):
        m = SUPPRESS_RE.search(line)
        if not m:
            continue
        ids = {part.strip() for part in m.group(1).split(",") if part.strip()}
        reason = (m.group(2) or "").strip()
        if not reason:
            bad.append(
                (
                    i,
                    m.start(),
                    "suppression without a reason: write "
                    "`# tev: disable=<rule> -- <why this is intentional>`",
                )
            )
            continue
        unknown = ids - known
        if unknown:
            # fail closed: a suppression naming ANY unknown rule
            # suppresses nothing — a typo'd id must surface both as a
            # bad-suppression (lint) and as the still-active underlying
            # finding, never as a silently green gate
            bad.append(
                (
                    i,
                    m.start(),
                    f"suppression names unknown rule(s) {sorted(unknown)}; "
                    f"known: {sorted(known)}",
                )
            )
            continue
        suppressions[i] = (ids, reason)
    return suppressions, bad


def parse_guarded_lines(lines: List[str]) -> Dict[int, str]:
    """``{line: lock_name}`` for every ``# tev: guarded-by=`` comment."""
    out: Dict[int, str] = {}
    for i, line in enumerate(lines, start=1):
        m = GUARDED_RE.search(line)
        if m:
            out[i] = m.group(1)
    return out


def parse_thread_scopes(lines: List[str]) -> Dict[int, str]:
    """``{line: scope}`` for every thread-context ``# tev: scope=``
    comment (worker/writer/watchdog — the jit/host spellings belong to
    the lint's file-level model and are deliberately not matched)."""
    out: Dict[int, str] = {}
    for i, line in enumerate(lines, start=1):
        m = THREAD_SCOPE_RE.search(line)
        if m:
            out[i] = m.group(1)
    return out
