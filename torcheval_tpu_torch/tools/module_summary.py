"""Module summaries for torch modules.

Counterpart of ``torcheval_tpu/tools/module_summary.py`` (reference
torcheval/tools/module_summary.py:73-759: ``ModuleSummary``,
``get_module_summary``, ``get_summary_table``,
``prune_module_summary``), with the same tree assembly and table:

- parameter and byte counts walk each submodule's parameters and
  buffers (the JAX package walks the variables pytree);
- activation sizes and the module tree come from one hooked forward
  (``capture_module_calls``);
- FLOPs are each captured call's own count on fake tensors
  (``tools/flops.py``: the analytic matmul/conv FLOPs);
- per-module forward time is the median of ``num_timing_iters`` calls of
  the submodule on its captured inputs after a warm-up call, each timed
  call between two synchronizes of the card (the JAX package's
  ``block_until_ready``).

A torch module holds its own parameters, so ``get_module_summary`` takes
no ``variables`` argument (the reference torcheval's signature).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from torcheval_tpu_torch.tools.flops import (
    ModuleCall,
    capture_module_calls,
    module_flops,
)

_UNKNOWN_SIZE = "?"


class ModuleSummary:
    """Summary of one (sub)module: name/type, parameter & byte counts,
    FLOPs, activation sizes, forward time, and a recursive tree of
    submodule summaries (reference module_summary.py:73-201)."""

    def __init__(self) -> None:
        self._module_name: str = ""
        self._module_type: str = ""
        self._num_parameters: int = 0
        self._num_trainable_parameters: int = 0
        self._size_bytes: int = 0
        self._submodule_summaries: Dict[str, "ModuleSummary"] = {}
        self._has_uninitialized_param: bool = False
        self._flops_forward: float = -1.0
        self._flops_backward: float = -1.0
        self._in_size: Optional[List[Tuple[int, ...]]] = None
        self._out_size: Optional[List[Tuple[int, ...]]] = None
        self._forward_elapsed_time_ms: float = -1.0

    @property
    def submodule_summaries(self) -> Dict[str, "ModuleSummary"]:
        return self._submodule_summaries

    @property
    def module_name(self) -> str:
        return self._module_name

    @property
    def module_type(self) -> str:
        return self._module_type

    @property
    def num_parameters(self) -> int:
        return self._num_parameters

    @property
    def num_trainable_parameters(self) -> int:
        return self._num_trainable_parameters

    @property
    def size_bytes(self) -> int:
        return self._size_bytes

    @property
    def has_uninitialized_param(self) -> bool:
        return self._has_uninitialized_param

    @property
    def flops_forward(self) -> float:
        return self._flops_forward

    @property
    def flops_backward(self) -> float:
        return self._flops_backward

    @property
    def in_size(self) -> Optional[List[Tuple[int, ...]]]:
        return self._in_size

    @property
    def out_size(self) -> Optional[List[Tuple[int, ...]]]:
        return self._out_size

    @property
    def forward_elapsed_time_ms(self) -> float:
        return self._forward_elapsed_time_ms

    def __repr__(self) -> str:
        return get_summary_table(self)


def _count_tensors(module: torch.nn.Module) -> Tuple[int, int, int, bool]:
    """(#elements, #trainable elements, #bytes, any lazy parameter) over
    the module's parameters and buffers; an uninitialized (lazy)
    parameter counts 0, as in the reference."""
    n = n_train = size = 0
    lazy = False
    for p in module.parameters():
        if isinstance(p, torch.nn.parameter.UninitializedParameter):
            lazy = True
            continue
        n += p.numel()
        size += p.numel() * p.element_size()
        if p.requires_grad:
            n_train += p.numel()
    for b in module.buffers():
        if isinstance(b, torch.nn.parameter.UninitializedBuffer):
            lazy = True
            continue
        n += b.numel()
        size += b.numel() * b.element_size()
    return n, n_train, size, lazy


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def _time_forward_ms(call: ModuleCall, iters: int) -> float:
    try:
        call.module(*call.in_arrays, **call.kwargs)  # warm-up
        times = []
        for _ in range(iters):
            _sync(call.device)
            start = time.perf_counter()
            call.module(*call.in_arrays, **call.kwargs)
            _sync(call.device)
            times.append((time.perf_counter() - start) * 1000.0)
        return float(np.median(times))
    except Exception:  # noqa: BLE001 -- a call that cannot run alone
        return -1.0


def get_module_summary(
    module: torch.nn.Module,
    module_args: Tuple[Any, ...] = (),
    module_kwargs: Optional[Dict[str, Any]] = None,
    *,
    compute_flops: bool = True,
    time_forward: bool = True,
    num_timing_iters: int = 3,
) -> ModuleSummary:
    """Summarize a torch module (reference module_summary.py:310-352).

    Args:
        module: the module.
        module_args / module_kwargs: one example input batch; needed for
            activation sizes, FLOPs and timing.
        compute_flops: count each submodule call's FLOPs on fake tensors.
        time_forward: time each submodule's forward on its captured
            inputs.
        num_timing_iters: timing repetitions (median reported).
    """
    module_kwargs = module_kwargs or {}
    calls: List[ModuleCall] = []
    if module_args or module_kwargs:
        calls, _ = capture_module_calls(
            module, *module_args, keep_arrays=time_forward, **module_kwargs
        )
    by_path = {
        tuple(name.split(".")) if name else (): m for name, m in module.named_modules()
    }

    summaries: Dict[Tuple[str, ...], ModuleSummary] = {}

    def summary_for(path: Tuple[str, ...], type_name: str) -> ModuleSummary:
        if path not in summaries:
            s = ModuleSummary()
            s._module_name = ".".join(path)
            s._module_type = type_name
            sub = by_path.get(path)
            if sub is not None:
                n_all, n_train, size, lazy = _count_tensors(sub)
                s._num_parameters = n_all
                s._num_trainable_parameters = n_train
                s._size_bytes = size
                s._has_uninitialized_param = lazy
            summaries[path] = s
        return summaries[path]

    # root from the module itself even without example inputs
    root = summary_for((), type(module).__name__)

    for call in calls:
        s = summary_for(call.path, call.type_name)
        s._in_size = [tuple(a.shape) for a in call.in_avals if hasattr(a, "shape")]
        s._out_size = [tuple(a.shape) for a in call.out_avals if hasattr(a, "shape")]
        if compute_flops:
            try:
                fwd = module_flops(call)
                s._flops_forward = fwd if s._flops_forward < 0 else s._flops_forward + fwd
            except Exception:  # noqa: BLE001 -- not countable alone: stays -1
                pass
            try:
                bwd = module_flops(call, backward=True)
                s._flops_backward = bwd if s._flops_backward < 0 else s._flops_backward + bwd
            except Exception:  # noqa: BLE001
                pass
        if time_forward:
            t = _time_forward_ms(call, num_timing_iters)
            if t >= 0:
                s._forward_elapsed_time_ms = (
                    t
                    if s._forward_elapsed_time_ms < 0
                    else s._forward_elapsed_time_ms + t
                )

    # assemble the tree: first materialize every ancestor (a module reached
    # without a call of its own has no captured entry), then link children
    # -- iterating a fresh snapshot so synthesized ancestors are linked too.
    for path in list(summaries):
        for depth in range(1, len(path)):
            sub = by_path.get(path[:depth])
            summary_for(path[:depth], type(sub).__name__ if sub is not None else "")
    for path in sorted(summaries, key=len):
        if path:
            summaries[path[:-1]]._submodule_summaries[".".join(path)] = summaries[path]
    return root


def prune_module_summary(module_summary: ModuleSummary, *, max_depth: int) -> None:
    """Drop submodule summaries deeper than ``max_depth`` in place
    (reference module_summary.py:503-520)."""
    if max_depth <= 1:
        module_summary._submodule_summaries = {}
        return
    for sub in module_summary._submodule_summaries.values():
        prune_module_summary(sub, max_depth=max_depth - 1)


def _human_count(n: float) -> str:
    for factor, suffix in ((1e12, " T"), (1e9, " B"), (1e6, " M"), (1e3, " K")):
        if abs(n) >= factor:
            return f"{n / factor:.1f}{suffix}"
    return str(int(n))


def _human_bytes(n: float) -> str:
    for factor, suffix in ((2**40, " TiB"), (2**30, " GiB"), (2**20, " MiB"), (2**10, " KiB")):
        if abs(n) >= factor:
            return f"{n / factor:.1f}{suffix}"
    return f"{int(n)} B"


def _human_flops(n: float) -> str:
    if n < 0:
        return _UNKNOWN_SIZE
    for factor, suffix in ((1e15, " PFLOP"), (1e12, " TFLOP"), (1e9, " GFLOP"), (1e6, " MFLOP"), (1e3, " kFLOP")):
        if abs(n) >= factor:
            return f"{n / factor:.2f}{suffix}"
    return f"{int(n)} FLOP"


def get_summary_table(
    module_summary: ModuleSummary, human_readable_nums: bool = True
) -> str:
    """Format a summary tree as an aligned text table
    (reference module_summary.py:523-647)."""
    rows: List[List[str]] = []

    def fmt_count(n: float) -> str:
        return _human_count(n) if human_readable_nums else str(int(n))

    def walk(s: ModuleSummary, depth: int) -> None:
        name = s.module_name or "(root)"
        rows.append(
            [
                "  " * depth + name,
                s.module_type,
                fmt_count(s.num_parameters),
                fmt_count(s.num_trainable_parameters),
                _human_bytes(s.size_bytes) if human_readable_nums else str(s.size_bytes),
                _human_flops(s.flops_forward) if human_readable_nums else str(s.flops_forward),
                _human_flops(s.flops_backward) if human_readable_nums else str(s.flops_backward),
                f"{s.forward_elapsed_time_ms:.3f}" if s.forward_elapsed_time_ms >= 0 else _UNKNOWN_SIZE,
                str(s.in_size) if s.in_size is not None else _UNKNOWN_SIZE,
                str(s.out_size) if s.out_size is not None else _UNKNOWN_SIZE,
            ]
        )
        for sub in s.submodule_summaries.values():
            walk(sub, depth + 1)

    walk(module_summary, 0)
    header = [
        "Name",
        "Type",
        "# Parameters",
        "# Trainable Parameters",
        "Size (bytes)",
        "Forward FLOPs",
        "Backward FLOPs",
        "Forward time (ms)",
        "In size",
        "Out size",
    ]
    widths = [
        max(len(header[i]), *(len(r[i]) for r in rows)) for i in range(len(header))
    ]
    lines = [
        " | ".join(h.ljust(w) for h, w in zip(header, widths)),
        "-+-".join("-" * w for w in widths),
    ]
    for r in rows:
        lines.append(" | ".join(c.ljust(w) for c, w in zip(r, widths)))
    return "\n".join(lines) + "\n"
