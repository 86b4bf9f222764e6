"""``Metric`` base class.

The counterpart of ``torcheval_tpu/metrics/metric.py`` with the same
surface -- ``update / compute / merge_state / reset / state_dict /
load_state_dict / to / device`` and the ``_add_state`` registry with
declarative merge kinds -- in eager PyTorch:

- State is torch tensors (plus Python int/float and list/dict containers)
  on ``self.device``: CUDA unless the metric was built with
  ``device="cpu"`` (see ``utils.convert.canonicalize_device``).
- An update plan runs through ``metrics/_fuse.py``:
  ``states += kernel(*dynamic, *config)``, or, for an ``UpdatePlan`` with
  ``transform=True``, ``states = kernel(states, *dynamic, *config)``. A
  plan's ``finalize`` (host-side, optional) runs after its states are set:
  a windowed metric advances its ring cursor there.
- Shape bucketing (``config.shape_bucketing``): a plan that declares
  ``masked_kernel`` and ``batch_axes`` is padded to its power-of-two
  bucket first (``metrics/_bucket.py``); on CUDA, under donation, that
  bucketed update is one CUDA-graph replay.
- Donation (``config.update_donation``, on by default for CUDA metrics):
  the new state is written into the live state tensor in place. So
  ``state_dict()`` hands out copies, ``load_state_dict`` copies what it
  takes, ``reset()`` writes the defaults into the live tensors, and a
  ``compute()`` result that would be a state tensor itself is copied
  (``_shield_compute_output``).
- Under ``config.validate_inputs`` every float input of ``update`` is
  checked for NaN/Inf (``_guard_finite``); off by default, since the check
  reads the input back to the host.

Left for later slices: shard bookkeeping, routing outboxes, mesh
shardings and the observability wrappers.
"""

from __future__ import annotations

import copy
import enum
import functools
import warnings
from abc import ABC, abstractmethod
from typing import Any, Dict, Generic, Iterable, List, NamedTuple, TypeVar, Union

import torch

from torcheval_tpu_torch import config
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
    ``finalize`` (host-side, optional) runs after the new states are set.

    ``masked_kernel`` + ``batch_axes`` opt the plan into shape bucketing
    (``metrics/_bucket.py``): under ``config.shape_bucketing()``, batch
    axes are zero-padded to power-of-two buckets and
    ``masked_kernel(*padded_dynamic, valid_sizes, *config)`` runs instead;
    it must make padded rows contribute exactly zero to every state, and
    must read ``valid_sizes`` (int32, on the metric's device) as a tensor,
    never as a host number, so one CUDA graph serves every count.
    ``batch_axes`` names the ragged axes of each dynamic argument: one
    tuple of dim labels per argument (positional from axis 0; ``None`` or
    empty for arguments with no ragged axis).
    """

    kernel: Any
    state_names: tuple
    dynamic: tuple
    config: tuple = ()
    transform: bool = False
    finalize: Any = None
    masked_kernel: Any = None
    batch_axes: tuple = ()


class MergeKind(enum.Enum):
    """Declarative cross-replica merge semantics for one state (the same
    members and values as the JAX package's ``MergeKind``)."""

    SUM = "sum"  # elementwise add (tensor / int / float / dict-of-tensor)
    MAX = "max"  # elementwise max
    MIN = "min"  # elementwise min
    EXTEND = "extend"  # list state: concatenate the per-replica lists
    CUSTOM = "custom"  # subclass overrides merge_state / _merge_custom_state


def _clone_state(value: Any) -> Any:
    """An independent copy: tensors are mutable, and an update may write
    a live state in place."""
    if isinstance(value, torch.Tensor):
        return value.detach().clone()
    if isinstance(value, list):
        return [_clone_state(v) for v in value]
    if isinstance(value, dict):
        return {k: _clone_state(v) for k, v in value.items()}
    return copy.deepcopy(value)


def _shield_compute_output(metric: "Metric", out: Any) -> Any:
    """Copy the tensors of a ``compute()`` result while donation is
    active: several computes return a STATE tensor itself (``Sum``, the
    confusion matrix with ``normalize=None``), and the next in-place update
    would change a value the caller already holds. Without donation this
    is a no-op (computes stay zero-copy)."""
    if not metric._donation_active():
        return out
    return _clone_state(out)


def _shielded(fn):
    @functools.wraps(fn)
    def compute(self, *args, **kwargs):
        return _shield_compute_output(self, fn(self, *args, **kwargs))

    compute._shielded = True
    return compute


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

    def __init_subclass__(cls, **kwargs: Any) -> None:
        """Wrap a concrete ``compute`` defined on this class with the
        donation shield (``_shield_compute_output``); inherited ones were
        wrapped where they were defined."""
        super().__init_subclass__(**kwargs)
        fn = cls.__dict__.get("compute")
        if (
            fn is not None
            and callable(fn)
            and not getattr(fn, "__isabstractmethod__", False)
            and not getattr(fn, "_shielded", False)
        ):
            cls.compute = _shielded(fn)

    # Donation: while True -- and ``config.update_donation_enabled`` holds
    # for this metric's device (on for CUDA by default) -- updates write
    # each new state into the live state tensor in place. State tensors
    # must therefore never escape the metric: ``state_dict`` copies,
    # ``compute`` results are shielded. A subclass whose states alias
    # outside tensors opts out by setting this False.
    _donated_update: bool = True

    def _donation_active(self) -> bool:
        return self._donated_update and config.update_donation_enabled(self._device)

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
        reference's ``input.to(self.device)``), through the NaN/Inf guard."""
        return self._guard_finite(to_torch(x, dtype=dtype, device=self._device))

    def _input_float(self, x: Any) -> torch.Tensor:
        return self._guard_finite(to_torch_float(x, device=self._device))

    def _guard_finite(self, x: torch.Tensor) -> torch.Tensor:
        """NaN/Inf guard (``config.validate_inputs``: off/warn/raise).

        The check reads the input back to the host, a stream
        synchronization on a card, which is why it is a knob that defaults
        to off; under ``"off"`` nothing is read. Integer and bool inputs
        pass untouched.
        """
        policy = config.validate_inputs_policy()
        if policy == "off" or not (x.is_floating_point() or x.is_complex()):
            return x
        if not bool(torch.all(torch.isfinite(x))):
            message = (
                f"{type(self).__name__}.update received non-finite values "
                "(NaN/Inf) in a float input "
                "(config.validate_inputs guardrail)"
            )
            if policy == "raise":
                raise ValueError(message)
            warnings.warn(message, RuntimeWarning, stacklevel=4)
        return x

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
        """Run one update plan against this metric's states: bucketed
        first when it declares a masked kernel, then through
        ``metrics/_fuse.py`` -- one CUDA-graph replay when bucketed on CUDA
        under donation, eager otherwise -- then its ``finalize``. The
        trailing ``config`` of a tuple plan may be omitted."""
        from torcheval_tpu_torch.metrics._bucket import apply_bucketing
        from torcheval_tpu_torch.metrics._fuse import (
            fused_accumulate,
            fused_transform,
            graphed_update_possible,
        )

        donate = self._donation_active()
        if isinstance(plan, UpdatePlan):
            graph = graphed_update_possible((self,))
            rewritten = apply_bucketing(plan, lazy=graph)
            graph = graph and rewritten is not plan
            plan = rewritten
            states = tuple(getattr(self, n) for n in plan.state_names)
            run = fused_transform if plan.transform else fused_accumulate
            new_states = run(
                plan.kernel, states, plan.dynamic, plan.config, donate=donate, graph=graph
            )
            for name, value in zip(plan.state_names, new_states):
                setattr(self, name, value)
            if plan.finalize is not None:
                plan.finalize()
            return self
        kernel, state_names, dynamic, *rest = plan
        config_ = rest[0] if rest else ()
        states = tuple(getattr(self, n) for n in state_names)
        new_states = fused_accumulate(kernel, states, dynamic, config_, donate=donate)
        for name, value in zip(state_names, new_states):
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
        """Restore every state to its registered default on ``self.device``.

        Under donation a tensor state whose default has its dtype and
        shape is overwritten in place, so the tensors -- and the CUDA
        graphs that write them -- outlive the reset."""
        donate = self._donation_active()
        for name, default in self._state_name_to_default.items():
            live = getattr(self, name, None)
            if (
                donate
                and isinstance(live, torch.Tensor)
                and isinstance(default, torch.Tensor)
                and live.dtype == default.dtype
                and live.shape == default.shape
                and live.device == self._device
            ):
                live.copy_(default, non_blocking=True)
            else:
                setattr(self, name, self._place_state(_clone_state(default)))
        # a provenance left by a prior (possibly degraded) sync describes
        # the state this reset discarded
        self.__dict__.pop("sync_provenance", None)
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
        # restored state replaces whatever a prior sync produced; the sync
        # path stamps its own provenance afterwards
        self.__dict__.pop("sync_provenance", None)

    # ---------------------------------------------------------------- devices

    # tensor attributes that are configuration, not state (a binned
    # metric's threshold grid): ``to`` moves them with the states
    _extra_device_attrs: tuple = ()

    def to(self: TSelf, device: DeviceLike, *args: Any, **kwargs: Any) -> TSelf:
        """Move all states, and the tensors named in
        ``_extra_device_attrs``, to ``device``."""
        target = canonicalize_device(device)
        for name in self._state_name_to_default:
            setattr(self, name, self._place_state(getattr(self, name), target))
        for name in self._extra_device_attrs:
            value = getattr(self, name)
            if value is not None:  # an optional tensor left unset
                setattr(self, name, value.to(target))
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
