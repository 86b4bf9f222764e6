"""FLOP counting for torch modules and functions.

Counterpart of ``torcheval_tpu/tools/flops.py``. The JAX package lowers
each (sub)module with XLA and reads ``cost_analysis()``; the port does
what the reference torcheval does (``FlopTensorDispatchMode``): it
intercepts aten calls and counts FLOPs from their shapes, through
``torch.utils.flop_counter.FlopCounterMode`` (matmuls, convolutions,
attention kernels and their backwards; elementwise work counts 0). Every
count runs on fake tensors (``FakeTensorMode``), so nothing executes and
nothing is allocated, as the JAX version only lowers. Per-module
attribution captures each submodule call with forward hooks (the
reference's design; the JAX package uses ``nn.intercept_methods``) and
counts that call alone.

Differences from the JAX package:

- counts are the analytic matmul/conv FLOPs, not XLA's post-fusion
  program count (which adds elementwise work: on the 2-layer test model
  5,505,024 here against XLA's 5,706,944);
- a torch module holds its own parameters, so ``FlopCounter(module)`` and
  ``capture_module_calls(module, ...)`` take no ``variables``;
- backward counts are the FLOPs of ``mean(fn).backward()`` over every
  floating tensor argument (parameters included), counted apart from the
  forward.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._pytree import tree_flatten, tree_map
from torch.utils.flop_counter import FlopCounterMode


def _fake_args(mode: FakeTensorMode, tree: Any, device: Optional[torch.device]) -> Any:
    """Tensors as fake tensors of ``mode``; a ``meta`` tensor becomes a
    fake tensor on ``device`` when one is given. Everything else as is."""

    def fake(a: Any) -> Any:
        if not isinstance(a, torch.Tensor):
            return a
        if a.is_meta and device is not None:
            return torch.empty(a.shape, dtype=a.dtype, device=device)
        return mode.from_tensor(a)

    return tree_map(fake, tree)


def _count(fn: Callable[..., Any], args: Tuple[Any, ...], kwargs: Dict[str, Any],
           backward: bool, device: Optional[torch.device] = None) -> float:
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fargs, fkwargs = _fake_args(mode, (args, kwargs), device)
        if not backward:
            with FlopCounterMode(display=False) as counter:
                fn(*fargs, **fkwargs)
            return float(counter.get_total_flops())
        leaves = [
            a for a in tree_flatten(fargs)[0]
            if isinstance(a, torch.Tensor) and a.is_floating_point()
        ]
        if not leaves:
            return 0.0
        for a in leaves:
            a.requires_grad_(True)
        with torch.enable_grad():
            outs = [
                o for o in tree_flatten(fn(*fargs, **fkwargs))[0]
                if isinstance(o, torch.Tensor) and o.is_floating_point() and o.requires_grad
            ]
            if not outs:
                return 0.0
            loss = sum(o.mean() for o in outs)
            with FlopCounterMode(display=False) as counter:
                torch.autograd.grad(loss, leaves, allow_unused=True)
        return float(counter.get_total_flops())


def count_flops(fn: Callable[..., Any], *args: Any, **kwargs: Any) -> float:
    """FLOPs of one call of ``fn``, counted on fake tensors: tensor
    arguments (real, fake or on the ``meta`` device) only lend their
    shapes, dtypes and devices, and tensors ``fn`` closes over are faked
    on the fly. Nothing executes.

    >>> import torch
    >>> from torcheval_tpu_torch.tools import count_flops
    >>> count_flops(lambda a, b: a @ b,
    ...             torch.empty(128, 64, device="meta"),
    ...             torch.empty(64, 32, device="meta"))
    524288.0
    """
    return _count(fn, args, kwargs, backward=False)


def count_flops_backward(fn: Callable[..., Any], *args: Any, **kwargs: Any) -> float:
    """FLOPs of the backward pass of ``fn`` with respect to every
    floating tensor in its positional arguments (nested in dicts, lists
    and tuples too), on fake tensors: the FLOPs of the gradient of
    ``sum(mean(out))`` over the floating outputs, the mean mirroring the
    reference's ``res.mean().backward()``. 0 when no argument or output
    is differentiable."""
    return _count(fn, args, kwargs, backward=True)


class ModuleCall(NamedTuple):
    """One captured submodule invocation."""

    path: Tuple[str, ...]
    type_name: str
    module: torch.nn.Module
    in_avals: Tuple[Any, ...]  # tensors as meta tensors, the rest as is
    in_arrays: Tuple[Any, ...]
    out_avals: Tuple[Any, ...]
    kwargs: Dict[str, Any]
    device: torch.device


def _aval(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
    return x


def capture_module_calls(
    module: torch.nn.Module, *args: Any, keep_arrays: bool = False, **kwargs: Any
) -> Tuple[List[ModuleCall], Any]:
    """Run one forward of ``module``, recording every submodule call (its
    dotted path, the module, input/output shapes as meta tensors) through
    forward hooks, children before parents. Returns ``(calls, output)``.

    ``keep_arrays=True`` also keeps each call's input tensors (per-module
    timing needs them); off by default so captured activations do not
    stay on the device.
    """
    names = {id(m): name for name, m in module.named_modules()}
    calls: List[ModuleCall] = []

    def hook(mod, f_args, f_kwargs, out):
        name = names.get(id(mod), "")
        out_leaves = tuple(
            _aval(x) for x in tree_flatten(out)[0] if isinstance(x, torch.Tensor)
        )
        tensors = [a for a in tree_flatten((f_args, f_kwargs))[0] if isinstance(a, torch.Tensor)]
        calls.append(
            ModuleCall(
                path=tuple(name.split(".")) if name else (),
                type_name=type(mod).__name__,
                module=mod,
                in_avals=tuple(_aval(a) for a in f_args),
                in_arrays=tuple(f_args) if keep_arrays else (),
                out_avals=out_leaves,
                kwargs=dict(f_kwargs),
                device=tensors[0].device if tensors else torch.device("cpu"),
            )
        )

    handles = [
        m.register_forward_hook(hook, with_kwargs=True) for m in module.modules()
    ]
    try:
        out = module(*args, **kwargs)
    finally:
        for h in handles:
            h.remove()
    return calls, out


def module_flops(call: ModuleCall, backward: bool = False) -> float:
    """FLOPs of one captured submodule call alone (forward, or the
    backward only), on fake tensors of the call's shapes and device."""
    state = dict(call.module.named_parameters())
    state.update(call.module.named_buffers())

    def apply_fn(params, *inputs):
        return torch.func.functional_call(call.module, params, inputs, call.kwargs)

    return _count(apply_fn, (state, *call.in_avals), {}, backward, call.device)


class FlopCounter:
    """Per-module FLOP counts of one forward (and backward) of a module.

    The reference analogue is ``FlopTensorDispatchMode``: ``flop_counts``
    maps the dotted module path (``""`` for the root) to its FLOPs,
    parents inclusive of children; a call that cannot be counted alone
    reads ``-1.0``.

    >>> fc = FlopCounter(model)
    >>> logits = fc.run(tokens)
    >>> fc.flop_counts[""], fc.flop_counts["Block_0"]
    """

    def __init__(self, module: torch.nn.Module) -> None:
        self.module = module
        self.flop_counts: Dict[str, float] = {}
        self.flop_counts_backward: Dict[str, float] = {}
        self._calls: List[ModuleCall] = []

    def run(self, *args: Any, backward: bool = False, **kwargs: Any) -> Any:
        """Forward the wrapped module, filling ``flop_counts`` (and
        ``flop_counts_backward`` when asked)."""
        self._calls, out = capture_module_calls(self.module, *args, **kwargs)
        self.flop_counts = {}
        self.flop_counts_backward = {}
        for call in self._calls:
            name = ".".join(call.path)
            try:
                self.flop_counts[name] = self.flop_counts.get(name, 0.0) + module_flops(call)
            except Exception:  # noqa: BLE001 -- a call not countable alone
                self.flop_counts[name] = -1.0
            if backward:
                try:
                    self.flop_counts_backward[name] = (
                        self.flop_counts_backward.get(name, 0.0)
                        + module_flops(call, backward=True)
                    )
                except Exception:  # noqa: BLE001
                    self.flop_counts_backward[name] = -1.0
        return out

    def reset(self) -> None:
        self.flop_counts = {}
        self.flop_counts_backward = {}
