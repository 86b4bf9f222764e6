"""Static analysis for torcheval_tpu_torch: verifier, lockstep checker, lint.

The counterpart of ``torcheval_tpu/analysis/``, with the same public
names, rule ids and one :class:`Finding`/:class:`Report` schema:

- ``analysis.lint`` -- AST house rules over source files, in their torch
  forms (stdlib-only: importable and runnable without torch);
- ``analysis.program`` -- the metric-program verifier: run update,
  compute and merge (or any step function) on fake tensors under a
  dispatch recorder and prove no host escapes, the collective census,
  donation soundness and dtype safety -- without executing a step;
- ``analysis.lockstep`` -- cross-rank collective lockstep: per-rank
  collective plans recorded on a loop-back group, plans diffed across
  seeded input variants, and eager ``synclib`` call-plan diffs, reported
  as would-deadlock findings;
- ``analysis.locks`` / ``analysis.concurrency`` -- the host-threading
  verifier: guarded-by lock discipline, lock-order cycles,
  blocking-under-lock and cross-thread collective hazards (stdlib-only,
  like the lint).

CLI: ``python -m torcheval_tpu_torch.analysis [paths...] --report json``.

Import discipline: this module eagerly exposes only the stdlib layers
(``report``, ``lint``, ``locks``, ``concurrency``); the torch-backed
verifier and lockstep symbols load lazily on first attribute access
(PEP 562), so a process that only lints stays torch-free.
"""

from __future__ import annotations

from torcheval_tpu_torch.analysis.concurrency import check_concurrency
from torcheval_tpu_torch.analysis.lint import (
    RULES,
    LintRule,
    lint_file,
    lint_paths,
    register_rule,
)
from torcheval_tpu_torch.analysis.locks import check_locks
from torcheval_tpu_torch.analysis.report import (
    Finding,
    Report,
    last_report,
    set_last_report,
)

# torch-backed symbols, resolved lazily via __getattr__
_LAZY = {
    "ProgramReport": "program",
    "assert_donated_update_in_place": "program",
    "assert_update_transfer_free": "program",
    "check_donation_aliasing": "program",
    "compare_collective_sequences": "program",
    "verify_metric_compute": "program",
    "verify_metric_merge": "program",
    "verify_metric_update": "program",
    "verify_program": "program",
    "CollectiveOp": "lockstep",
    "PlanRecordingGroup": "lockstep",
    "check_eager_lockstep": "lockstep",
    "check_program_lockstep": "lockstep",
    "collective_plan": "lockstep",
    "eager_sync_plan": "lockstep",
    "verify_rank_lockstep": "lockstep",
}

__all__ = sorted(
    [
        "Finding",
        "LintRule",
        "RULES",
        "Report",
        "check_concurrency",
        "check_locks",
        "last_report",
        "lint_file",
        "lint_paths",
        "register_rule",
        "set_last_report",
        *_LAZY,
    ]
)


def __getattr__(name: str):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        )
    import importlib

    mod = importlib.import_module(f"{__name__}.{module}")
    value = getattr(mod, name)
    globals()[name] = value
    return value


def __dir__():
    return __all__
