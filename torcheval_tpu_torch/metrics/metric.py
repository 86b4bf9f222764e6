"""``Metric`` base class.

The counterpart of ``torcheval_tpu/metrics/metric.py`` with the same
surface -- ``update / compute / merge_state / reset / state_dict /
load_state_dict / to / device`` and the ``_add_state`` registry with
declarative merge kinds -- in eager PyTorch:

- State is torch tensors (plus Python int/float and list/dict containers)
  on ``self.device``: CUDA unless the metric was built with
  ``device="cpu"`` (see ``utils.convert.canonicalize_device``).
- An update plan runs eagerly: ``states += kernel(*dynamic, *config)``,
  or, for an ``UpdatePlan`` with ``transform=True``,
  ``states = kernel(states, *dynamic, *config)``. There is no jit and no
  plan cache. A transform kernel may update a state tensor in place;
  ``state_dict()`` therefore hands out copies and ``load_state_dict``
  copies what it takes.

Left for later slices: shard bookkeeping, routing outboxes, donation,
shape bucketing, mesh shardings and the observability wrappers.
"""

from __future__ import annotations

import copy
import enum
from abc import ABC, abstractmethod
from typing import Any, Dict, Generic, Iterable, List, NamedTuple, TypeVar, Union

import torch

from torcheval_tpu_torch.utils.convert import (
    DeviceLike,
    canonicalize_device,
    to_torch,
    to_torch_float,
)

TState = Union[torch.Tensor, List[torch.Tensor], Dict[Any, torch.Tensor], int, float]
TComputeReturn = TypeVar("TComputeReturn")
TSelf = TypeVar("TSelf", bound="Metric")


class UpdatePlan(NamedTuple):
    """A metric update factored as kernel + states (see
    :meth:`Metric._update_plan`).

    ``transform=False``: ``states += kernel(*dynamic, *config)``.
    ``transform=True``: ``states = kernel(states, *dynamic, *config)``.
    """

    kernel: Any
    state_names: tuple
    dynamic: tuple
    config: tuple = ()
    transform: bool = False


class MergeKind(enum.Enum):
    """Declarative cross-replica merge semantics for one state (the same
    members and values as the JAX package's ``MergeKind``)."""

    SUM = "sum"  # elementwise add (tensor / int / float / dict-of-tensor)
    MAX = "max"  # elementwise max
    MIN = "min"  # elementwise min
    EXTEND = "extend"  # list state: concatenate the per-replica lists
    CUSTOM = "custom"  # subclass overrides merge_state / _merge_custom_state


def _clone_state(value: TState) -> TState:
    """An independent copy: tensors are mutable, and a transform kernel
    may update a live state in place."""
    if isinstance(value, torch.Tensor):
        return value.detach().clone()
    if isinstance(value, list):
        return [_clone_state(v) for v in value]
    if isinstance(value, dict):
        return {k: _clone_state(v) for k, v in value.items()}
    return copy.deepcopy(value)


def _run_plan(plan, states: tuple) -> tuple:
    """Execute one update plan eagerly; returns the new state tuple."""
    if isinstance(plan, UpdatePlan):
        kernel, dynamic, config, transform = (
            plan.kernel, plan.dynamic, plan.config, plan.transform
        )
    else:
        kernel, _, dynamic, *rest = plan
        config, transform = (rest[0] if rest else ()), False
    if transform:
        out = kernel(states, *dynamic, *config)
    else:
        out = kernel(*dynamic, *config)
    if not isinstance(out, tuple):
        out = (out,)
    if len(out) != len(states):
        raise ValueError(
            f"update kernel {getattr(kernel, '__name__', kernel)!r} returned "
            f"{len(out)} outputs for {len(states)} states"
        )
    if transform:
        return out
    return tuple(s + d for s, d in zip(states, out))


class Metric(Generic[TComputeReturn], ABC):
    """Base class for all torcheval_tpu_torch metrics.

    Subclasses register states with ``_add_state`` in ``__init__`` and
    implement ``update``/``compute``; ``merge_state`` is derived from the
    registered merge kinds unless overridden.
    """

    def __init__(self, *, device: DeviceLike = None) -> None:
        self._state_name_to_default: Dict[str, TState] = {}
        self._state_name_to_merge_kind: Dict[str, MergeKind] = {}
        self._device: torch.device = canonicalize_device(device)

    # ------------------------------------------------------------------ state

    @property
    def device(self) -> torch.device:
        return self._device

    def _add_state(
        self, name: str, default: TState, *, merge: MergeKind = MergeKind.CUSTOM
    ) -> None:
        """Register a state variable. ``default`` is a tensor, a list of
        tensors, a dict with tensor values, an int, or a float; it is
        snapshotted for ``reset()`` and the live value (an independent
        copy) is placed on ``self.device``."""
        self._check_state_variable_type(name, default)
        self._state_name_to_default[name] = _clone_state(default)
        self._state_name_to_merge_kind[name] = merge
        setattr(self, name, self._place_state(_clone_state(default)))

    def _place_state(self, value: TState, device: DeviceLike = None) -> TState:
        device = device or self._device
        if isinstance(value, torch.Tensor):
            return value.to(device)
        if isinstance(value, list):
            return [v.to(device) for v in value]
        if isinstance(value, dict):
            return {k: v.to(device) for k, v in value.items()}
        return value

    def _check_state_variable_type(self, name: str, value: TState) -> None:
        if isinstance(value, (torch.Tensor, int, float)):
            return
        if isinstance(value, list):
            if all(isinstance(v, torch.Tensor) for v in value):
                return
            raise TypeError(
                f"The value of state variable `{name}` must be a list of "
                f"torch.Tensor, got {value!r}."
            )
        if isinstance(value, dict):
            if all(isinstance(v, torch.Tensor) for v in value.values()):
                return
            raise TypeError(
                f"The values of state variable dict `{name}` must be "
                f"torch.Tensor, got {value!r}."
            )
        raise TypeError(
            "The value of state variable must be a torch.Tensor, a list of "
            "torch.Tensor, a dict with torch.Tensor values, an int, or a "
            f"float; got `{name}` = {value!r}."
        )

    # --------------------------------------------------------- input boundary

    def _input(self, x: Any, *, dtype: Any = None) -> torch.Tensor:
        """Coerce an ``update()`` argument onto ``self.device`` (the
        reference's ``input.to(self.device)``)."""
        return to_torch(x, dtype=dtype, device=self._device)

    def _input_float(self, x: Any) -> torch.Tensor:
        return to_torch_float(x, device=self._device)

    # ------------------------------------------------------- abstract surface

    @abstractmethod
    def update(self: TSelf, *_: Any, **__: Any) -> TSelf:
        """Accumulate a batch into metric state."""

    def _update_plan(self, *args: Any, **kwargs: Any):
        """The update factored as a plan -- a tuple ``(kernel,
        state_names, dynamic[, config])`` or an :class:`UpdatePlan` -- or
        ``None`` when the update is not expressed as one. Implementations
        validate their inputs here, so a returned plan is safe to run;
        ``toolkit.update_collection`` builds every metric's plan before it
        runs any of them."""
        return None

    def _apply_update_plan(self: TSelf, plan) -> TSelf:
        """Run one update plan against this metric's states."""
        names = plan.state_names if isinstance(plan, UpdatePlan) else plan[1]
        states = tuple(getattr(self, n) for n in names)
        for name, value in zip(names, _run_plan(plan, states)):
            setattr(self, name, value)
        return self

    @abstractmethod
    def compute(self) -> TComputeReturn:
        """Finalize the metric value from state. Idempotent."""

    # ------------------------------------------------------------------ merge

    def merge_state(self: TSelf, metrics: Iterable[TSelf]) -> TSelf:
        """Merge peer replicas' states into self, by the registered merge
        kinds, one peer at a time in the order given."""
        for other in list(metrics):
            for name, kind in self._state_name_to_merge_kind.items():
                mine = getattr(self, name)
                theirs = self._place_state(getattr(other, name))
                setattr(self, name, self._merge_one(name, kind, mine, theirs))
        return self

    def _merge_one(
        self, name: str, kind: MergeKind, mine: TState, theirs: TState
    ) -> TState:
        if kind is MergeKind.SUM:
            if isinstance(mine, dict):
                for k, v in theirs.items():
                    mine[k] = mine[k] + v if k in mine else v
                return mine
            return mine + theirs
        if kind is MergeKind.MAX:
            if isinstance(mine, (int, float)):
                return max(mine, theirs)
            return torch.maximum(mine, theirs)
        if kind is MergeKind.MIN:
            if isinstance(mine, (int, float)):
                return min(mine, theirs)
            return torch.minimum(mine, theirs)
        if kind is MergeKind.EXTEND:
            mine.extend(theirs)
            return mine
        return self._merge_custom_state(name, mine, theirs)

    def _merge_custom_state(self, name: str, mine: TState, theirs: TState) -> TState:
        raise NotImplementedError(
            f"{type(self).__name__} registered state `{name}` with "
            "MergeKind.CUSTOM but does not override merge_state or "
            "_merge_custom_state."
        )

    # ------------------------------------------------------------------ reset

    def reset(self: TSelf) -> TSelf:
        """Restore every state to its registered default on ``self.device``."""
        for name, default in self._state_name_to_default.items():
            setattr(self, name, self._place_state(_clone_state(default)))
        return self

    # ---------------------------------------------------------- serialization

    def state_dict(self) -> Dict[str, TState]:
        """Snapshot of all states (independent copies)."""
        return {
            name: _clone_state(getattr(self, name))
            for name in self._state_name_to_default
        }

    def _sync_state_dict(self) -> Dict[str, TState]:
        """What a sync ships of this metric: ``state_dict()`` unless a
        subclass trims it (buffered metrics send their valid prefix, not
        their capacity). Checkpoints keep using ``state_dict()``."""
        return self.state_dict()

    def load_state_dict(
        self, state_dict: Dict[str, TState], strict: bool = True
    ) -> None:
        """Load a snapshot; the metric keeps copies, never the caller's
        tensors."""
        registered = set(self._state_name_to_default)
        provided = set(state_dict)
        if strict and registered != provided:
            raise RuntimeError(
                "Error(s) in loading state_dict for "
                f"{type(self).__name__}: "
                f"missing keys: {sorted(registered - provided)}, "
                f"unexpected keys: {sorted(provided - registered)}."
            )
        for name in registered & provided:
            value = state_dict[name]
            self._check_state_variable_type(name, value)
            setattr(self, name, self._place_state(_clone_state(value)))

    # ---------------------------------------------------------------- devices

    def to(self: TSelf, device: DeviceLike, *args: Any, **kwargs: Any) -> TSelf:
        """Move all states to ``device``."""
        target = canonicalize_device(device)
        for name in self._state_name_to_default:
            setattr(self, name, self._place_state(getattr(self, name), target))
        self._device = target
        return self

    # --------------------------------------------------------------- pickling

    def __getstate__(self) -> Dict[str, Any]:
        state = dict(self.__dict__)
        state["_device"] = str(self._device)
        return state

    def __setstate__(self, state: Dict[str, Any]) -> None:
        state["_device"] = torch.device(state["_device"])
        self.__dict__.update(state)
        for name in self._state_name_to_default:
            setattr(self, name, self._place_state(getattr(self, name)))
