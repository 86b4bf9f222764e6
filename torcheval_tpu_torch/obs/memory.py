"""Device-cost accounting: what does a metric panel cost to keep?

Counterpart of ``torcheval_tpu/obs/memory.py``, with the same names and
report layout. It answers the question a serving-scale eval panel has to
answer before it can be scheduled: *how many device bytes does each
metric's state pin, and what does one update cost?*

- :func:`state_bytes` / :func:`memory_report` — per-metric state bytes
  from a host-side walk of the REGISTERED state leaves (a
  ``torch.Tensor``'s bytes are shape x dtype metadata, read without
  touching the device; int/float scalars count as 8). Works on any
  constructed metric, fed or not.
- :func:`per_rank_state_bytes` / :func:`logical_state_bytes` — what this
  rank pins against what one unsharded replica would: a sharded state
  (``Metric(shard=...)``) counts its live slice per rank and its
  registered logical shape logically; routed outboxes are per-rank
  overhead and count as they are. A keyed metric table
  (``table.MetricTable``, hash-partitioned, so it has no axis-sharded
  states) supplies its own logical accounting through the
  ``_logical_state_nbytes`` hook: per-key rows times the pow2 slot
  capacity of its last-known global key count, outbox and bookkeeping as
  live.
- :func:`program_costs` / :func:`metric_update_costs` — the JAX package
  lowers and compiles an update without running it and reads XLA's
  memory and cost analyses. Eager torch has no such analysis, so what
  the port reports it measures by running, and always on copies: the
  function on deep copies of its arguments, a metric's update on a deep
  copy of the metric, never on the live states. Measured: ``flops``
  (``torch.utils.flop_counter.FlopCounterMode``, which counts the
  matmuls and convolutions it knows and nothing else), and the bytes of
  the arguments and of the outputs. ``None``, with the reason: ``temp_bytes``
  and ``peak_bytes`` (no buffer-liveness analysis exists for an eager
  call, and reading the allocator's peak would disturb the caller's own
  peak statistics) and ``generated_code_bytes`` (eager torch generates
  no program).

:func:`track_metrics` federates the state-bytes walk into the
``CounterRegistry`` as a pull-based source, so one Prometheus scrape
answers "what does this metric panel cost" next to the sync/compile/
snapshot counters.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Mapping, Optional

import torch

__all__ = [
    "logical_state_bytes",
    "memory_report",
    "metric_update_costs",
    "per_rank_state_bytes",
    "program_costs",
    "state_bytes",
    "track_metrics",
]


def _leaf_bytes(value: Any) -> int:
    """Device bytes of one state leaf (metadata only — no device read).

    int/float scalar states count as 8 (one 64-bit host word): they live
    on the host, but they are part of the state a sync ships and a
    snapshot persists, so the report includes them rather than hiding
    them at 0.
    """
    if isinstance(value, torch.Tensor):
        return int(value.numel() * value.element_size())
    if isinstance(value, (int, float)):
        return 8
    if isinstance(value, (list, tuple)):
        return sum(_leaf_bytes(v) for v in value)
    if isinstance(value, dict):
        return sum(_leaf_bytes(v) for v in value.values())
    return 0


def state_bytes(metric) -> Dict[str, int]:
    """Per-state device bytes of one metric: ``{state_name: bytes}``
    over the states registered via ``Metric._add_state`` (the same
    registry ``state_dict``/sync/snapshot traverse)."""
    return {
        name: _leaf_bytes(getattr(metric, name))
        for name in metric._state_name_to_default
    }


def per_rank_state_bytes(metric) -> Dict[str, int]:
    """Per-state bytes THIS rank pins: the live walk, since a sharded
    state lives as this rank's slice (the JAX package's mesh-sharded
    per-device division has no counterpart here)."""
    return state_bytes(metric)


def logical_state_bytes(metric) -> Dict[str, int]:
    """Per-state bytes of the LOGICAL (unsharded) state — what one
    replica would pin. Sharded states report their registered logical
    shape; routed outboxes are per-rank overhead and count as they are. A
    metric with a ``_logical_state_nbytes`` hook (the keyed metric tables,
    ``table.MetricTable``) supplies its own accounting."""
    hook = getattr(metric, "_logical_state_nbytes", None)
    if hook is not None:
        return dict(hook())
    out = state_bytes(metric)
    for name, info in (getattr(metric, "_sharded_states", None) or {}).items():
        item = torch.empty((), dtype=info.dtype).element_size()
        out[name] = int(info.logical_size * item)
    return out


def memory_report(
    metrics: Mapping[str, Any],
) -> Dict[str, Dict[str, Any]]:
    """Per-metric state-byte accounting for a ``{name: Metric}`` panel.

    Returns ``{name: {"metric": class-name, "state_bytes": total,
    "logical_bytes": ..., "per_rank_bytes": ..., "sharded": bool,
    "states": {state: bytes}}}``. ``logical_bytes`` is what one
    unsharded replica would pin; ``per_rank_bytes`` is what THIS rank
    pins (equal for replicated metrics; ``~logical/world + outbox`` for
    sharded ones). Pure metadata walk — no update
    runs, no device read, no collective. When the observability recorder
    is on, one :class:`~torcheval_tpu_torch.obs.events.MemoryEvent` per
    metric lands in the event stream.
    """
    from torcheval_tpu_torch.obs.recorder import RECORDER

    report: Dict[str, Dict[str, Any]] = {}
    for name, metric in metrics.items():
        per_state = state_bytes(metric)
        total = sum(per_state.values())
        logical = sum(logical_state_bytes(metric).values())
        per_rank = sum(per_rank_state_bytes(metric).values())
        report[name] = {
            "metric": type(metric).__name__,
            "state_bytes": total,
            "logical_bytes": logical,
            "per_rank_bytes": per_rank,
            "sharded": per_rank != logical,
            "states": per_state,
        }
        if RECORDER.enabled:
            from torcheval_tpu_torch.obs.events import MemoryEvent

            RECORDER.record(
                MemoryEvent(
                    metric=name,
                    state_bytes=total,
                    states=len(per_state),
                    logical_bytes=logical,
                    per_rank_bytes=per_rank,
                )
            )
    return report


def _tree_bytes(tree: Any) -> int:
    if isinstance(tree, torch.Tensor):
        return _leaf_bytes(tree)
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return 0


def _measured(run: Callable[[], Any], argument_bytes: int) -> Dict[str, Optional[float]]:
    """Run ``run`` (on copies, see the module docstring) under the FLOP
    counter; fields this cannot give are ``None``."""
    out: Dict[str, Optional[float]] = {
        "flops": None,
        "argument_bytes": argument_bytes,
        "output_bytes": None,
        "temp_bytes": None,
        "peak_bytes": None,
        "generated_code_bytes": None,
    }
    try:
        from torch.utils.flop_counter import FlopCounterMode

        counter = FlopCounterMode(display=False)
        with counter:
            result = run()
    except Exception:  # noqa: BLE001 — a call that cannot run costs None, not a crash
        return out
    out["flops"] = float(counter.get_total_flops())
    out["output_bytes"] = _tree_bytes(result)
    return out


def program_costs(fn: Callable[..., Any], *args: Any, **kwargs: Any) -> Dict[str, Optional[float]]:
    """Cost sheet of one call: ``{"flops", "argument_bytes",
    "output_bytes", "temp_bytes", "peak_bytes", "generated_code_bytes"}``.

    ``fn`` runs once on deep copies of ``args``/``kwargs`` (the caller's
    tensors are never written); ``temp_bytes``, ``peak_bytes`` and
    ``generated_code_bytes`` are ``None`` (see the module docstring), and
    so are ``flops`` and ``output_bytes`` when the call raises.
    """
    argument_bytes = _tree_bytes(list(args) + list(kwargs.values()))
    args_c, kwargs_c = copy.deepcopy(args), copy.deepcopy(kwargs)
    return _measured(lambda: fn(*args_c, **kwargs_c), argument_bytes)


def metric_update_costs(metric, *args: Any, **kwargs: Any) -> Optional[Dict[str, Optional[float]]]:
    """:func:`program_costs` of ``metric``'s update for one example batch,
    run on a deep copy of the metric (the live states never change).
    ``argument_bytes`` counts the states and the batch, as the JAX
    package's fused update program takes both. Returns ``None`` for
    metrics without an update plan (host-side text processing, buffered
    appends), as the JAX package does."""
    clone = copy.deepcopy(metric)
    if clone._update_plan(*args, **kwargs) is None:
        return None
    states = sum(state_bytes(metric).values())
    argument_bytes = states + _tree_bytes(list(args) + list(kwargs.values()))

    def run():
        clone.update(*args, **kwargs)
        return [getattr(clone, n) for n in clone._state_name_to_default]

    return _measured(run, argument_bytes)


def track_metrics(
    metrics: Mapping[str, Any],
    *,
    source: str = "memory",
    registry=None,
) -> Callable[[], Dict[str, Any]]:
    """Register a pull-based ``{metric}_state_bytes`` counter source for
    a metric panel, so ``render_prometheus()`` / ``format_report()`` /
    ``gather_observability()`` carry the panel's device-byte cost next
    to the existing counters. The MAPPING is captured, not a snapshot:
    every scrape re-walks the live metrics (zero cost between scrapes —
    the ``CounterRegistry`` supplier contract). Returns the supplier;
    unregister with ``registry.unregister(source)``."""
    from torcheval_tpu_torch.obs.counters import default_registry

    if registry is None:
        registry = default_registry()

    def supplier() -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        total = 0
        total_rank = 0
        for name, metric in metrics.items():
            n = sum(state_bytes(metric).values())
            pr = sum(per_rank_state_bytes(metric).values())
            out[f"{name}_state_bytes"] = n
            out[f"{name}_per_rank_bytes"] = pr
            total += n
            total_rank += pr
        out["total_state_bytes"] = total
        out["total_per_rank_bytes"] = total_rank
        return out

    registry.register(source, supplier)
    return supplier
