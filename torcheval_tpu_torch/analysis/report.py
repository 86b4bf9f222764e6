"""Shared finding/report types for the static-analysis subsystem.

The counterpart of ``torcheval_tpu/analysis/report.py``, with the same
schema (version 1). Every analyzer layer (``lint`` -- AST house rules,
``program`` -- the dispatch-level census of a metric program,
``lockstep`` -- cross-rank collective plans, ``concurrency`` -- lock
discipline and thread hazards) emits the same :class:`Finding` record, so
one JSON schema feeds the CLI and the tests. Deliberately stdlib-only: the
AST lint and the concurrency verifier must be importable and runnable
without torch.

Findings integrate with the observability subsystem
(``torcheval_tpu_torch.obs``) as typed ``AnalysisEvent``s -- emitted
lazily and only while the recorder is on, so analysis runs inside an
instrumented eval job leave forensics and a plain lint run stays
torch-free.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

__all__ = [
    "Finding",
    "Report",
    "last_report",
    "set_last_report",
]

REPORT_SCHEMA_VERSION = 1


@dataclass
class Finding:
    """One rule violation (or would-deadlock hazard) at one location.

    ``tool`` names the analyzer layer (``lint`` / ``program`` /
    ``lockstep`` / ``concurrency``), ``rule`` the registry id (the
    module docstrings of ``lint``, ``program``, ``lockstep``, ``locks``
    and ``concurrency`` have the catalogue). ``path`` is a file for lint findings and a program
    label (e.g. ``MulticlassAccuracy.update``) for verifier findings;
    ``line`` is 1-based (0 = whole-program finding). ``suppressed`` marks
    a finding covered by a ``# tev: disable=<rule> -- reason`` comment —
    kept in the report (with its reason) so suppressions stay auditable,
    but excluded from the pass/fail verdict.
    """

    tool: str
    rule: str
    path: str
    message: str
    line: int = 0
    col: int = 0
    severity: str = "error"  # "error" | "warning"
    suppressed: bool = False
    suppress_reason: str = ""

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def format(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        tag = f"[{self.tool}:{self.rule}]"
        sup = (
            f" (suppressed: {self.suppress_reason})" if self.suppressed else ""
        )
        return f"{loc}: {self.severity} {tag} {self.message}{sup}"


@dataclass
class Report:
    """An analyzer run's findings plus enough context to act on them."""

    tool: str
    findings: List[Finding] = field(default_factory=list)
    checked: int = 0  # files (lint) or programs (verifier) examined

    @property
    def ok(self) -> bool:
        """True when no UNSUPPRESSED error-severity finding remains."""
        return not any(
            f.severity == "error" and not f.suppressed for f in self.findings
        )

    @property
    def active(self) -> List[Finding]:
        return [f for f in self.findings if not f.suppressed]

    def extend(self, other: "Report") -> "Report":
        self.findings.extend(other.findings)
        self.checked += other.checked
        return self

    def as_dict(self) -> Dict[str, Any]:
        active = self.active
        return {
            "schema_version": REPORT_SCHEMA_VERSION,
            "tool": self.tool,
            "ok": self.ok,
            "checked": self.checked,
            "counts": {
                "total": len(self.findings),
                "active": len(active),
                "suppressed": len(self.findings) - len(active),
                "errors": sum(
                    1 for f in active if f.severity == "error"
                ),
                "warnings": sum(
                    1 for f in active if f.severity == "warning"
                ),
            },
            "findings": [f.as_dict() for f in self.findings],
        }

    def to_json(self, *, indent: Optional[int] = 2) -> str:
        return json.dumps(self.as_dict(), indent=indent, sort_keys=False)

    def format_text(self, *, include_suppressed: bool = True) -> str:
        lines = [
            f.format()
            for f in self.findings
            if include_suppressed or not f.suppressed
        ]
        counts = self.as_dict()["counts"]
        lines.append(
            f"{self.tool}: {self.checked} checked, "
            f"{counts['errors']} error(s), {counts['warnings']} warning(s), "
            f"{counts['suppressed']} suppressed -> "
            f"{'OK' if self.ok else 'FAIL'}"
        )
        return "\n".join(lines)

    def record_events(self) -> None:
        """Mirror active findings into the observability recorder as
        ``AnalysisEvent``s (no-op — one attribute read — when the
        recorder is off, the same contract as every instrumented site).
        Lazy import: a lint-only process never imports torch.

        Idempotent PER FINDING (an ``_obs_recorded`` marker on the
        record, not a dataclass field): composite verifiers pass the
        same ``Finding`` objects through several ``set_last_report``
        layers (sub-report → extended parent), and each must land in the
        event log exactly once."""
        import sys

        recorder_mod = sys.modules.get("torcheval_tpu_torch.obs.recorder")
        if recorder_mod is None or not recorder_mod.RECORDER.enabled:
            return
        from torcheval_tpu_torch.obs.events import AnalysisEvent

        for f in self.active:
            if getattr(f, "_obs_recorded", False):
                continue
            recorder_mod.RECORDER.record(
                AnalysisEvent(
                    tool=f.tool,
                    rule=f.rule,
                    path=f.path,
                    line=f.line,
                    severity=f.severity,
                    message=f.message,
                )
            )
            f._obs_recorded = True


# The most recent report of any analyzer entry point in this process:
# what a failure-forensics hook attaches next to the obs event tail when
# a run that used the analyzer fails.
_LAST_REPORT: Optional[Report] = None


def set_last_report(report: Report) -> Report:
    global _LAST_REPORT
    _LAST_REPORT = report
    report.record_events()
    return report


def last_report() -> Optional[Report]:
    return _LAST_REPORT
