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
- Observability (``torcheval_tpu_torch.obs``): every concrete ``update``
  and ``compute`` is wrapped (``_instrumented``). With the recorder off
  the wrapper costs one attribute read; on, the call gets a span, a
  latency digest entry and an ``UpdateEvent``/``ComputeEvent``, and an
  update stamps ``obs_step``.

- Sharded state (``metrics/shardspec.py``): ``Metric(shard=
  ShardContext(rank, world))`` keeps each state registered with
  ``_add_state(..., shard=ShardSpec(0))`` as this rank's slice of axis 0.
  Routed states carry an outbox of foreign contributions, the sync ships
  the shard plus the trimmed outbox, and ``merge_state`` reassembles the
  logical state from shard carriers (``_merge_sharded``). The JAX
  package's mesh form (``out_shardings`` on the fused update) has no torch
  counterpart (see ``shardspec``).
"""

from __future__ import annotations

import copy
import enum
import functools
import time
import types
import warnings
from abc import ABC, abstractmethod
from typing import Any, Dict, Generic, Iterable, List, NamedTuple, Optional, TypeVar, Union

import torch

from torcheval_tpu_torch import config
from torcheval_tpu_torch.obs import hist as _obs_hist
from torcheval_tpu_torch.obs import trace as _obs_trace
from torcheval_tpu_torch.obs.events import ComputeEvent, UpdateEvent
from torcheval_tpu_torch.obs.recorder import RECORDER as _OBS
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


def as_update_plan(plan: Any, metric: Any) -> Optional[UpdatePlan]:
    """``metric``'s update plan in the one form past the plan boundary:
    ``None`` stays ``None``, an :class:`UpdatePlan` passes through, and a
    tuple ``(kernel, state_names, dynamic[, config])`` becomes
    ``UpdatePlan(kernel, state_names, dynamic, config)``."""
    if plan is None or isinstance(plan, UpdatePlan):
        return plan
    if isinstance(plan, tuple) and len(plan) in (3, 4):
        return UpdatePlan(*plan)
    raise TypeError(
        f"{type(metric).__name__}._update_plan returned a {type(plan).__name__}; "
        "expected None, an UpdatePlan or a (kernel, state_names, dynamic[, config]) tuple"
    )


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
    if isinstance(value, tuple):
        items = [_clone_state(v) for v in value]
        return type(value)(*items) if hasattr(value, "_fields") else tuple(items)
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


def _instrumented(fn, phase: str, cls_name: str):
    """Wrap a subclass's ``update``/``compute`` with observability (and,
    for ``compute``, the donation output shield: ``_shield_compute_output``).

    Recorder OFF (the default): one attribute read, then the original
    function. Recorder ON: the call is timed on the host clock (on the
    card that is the time to enqueue its kernels, not their device time),
    opened as a ``torch.profiler.record_function`` range and a
    causal-tracing span frame (``obs/trace.py``: a CUDA-graph capture or a
    retry inside parents to this update), fed into the per-family latency
    digest (``obs/hist.py``) and recorded as an ``UpdateEvent``/
    ``ComputeEvent``; an update also stamps ``obs_step`` (the recorder's
    step cursor) on the metric, cleared by ``reset()`` and
    ``load_state_dict``. All of it is host bookkeeping around the call: no
    host sync, no device allocation, no collective, and nothing between a
    capture's begin and end (a capture happens inside the call).
    """
    label = f"torcheval.{phase}/{cls_name}"
    is_compute = phase == "compute"

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        if not _OBS.enabled:
            out = fn(self, *args, **kwargs)
            return _shield_compute_output(self, out) if is_compute else out
        # inline frame management (not trace.Scope): this is THE hot
        # instrumented path
        frame = _obs_trace.push(label)
        t0 = time.monotonic()
        try:
            with torch.profiler.record_function(label):
                out = fn(self, *args, **kwargs)
        except BaseException as e:
            _obs_trace.capture_error(e)
            raise
        finally:
            _obs_trace.pop(frame)
        seconds = time.monotonic() - t0
        name = type(self).__name__
        _obs_hist.observe(f"{phase}/{name}", seconds)
        if phase == "update":
            self.obs_step = _OBS.step_cursor
            _OBS.record(
                UpdateEvent(
                    metric=name,
                    seconds=seconds,
                    trace=frame.trace_id,
                    span=frame.span_id,
                    parent=frame.parent_id,
                )
            )
        else:
            out = _shield_compute_output(self, out)
            _OBS.record(
                ComputeEvent(
                    metric=name,
                    seconds=seconds,
                    trace=frame.trace_id,
                    span=frame.span_id,
                    parent=frame.parent_id,
                )
            )
        return out

    wrapper._obs_instrumented = True
    return wrapper


class Metric(Generic[TComputeReturn], ABC):
    """Base class for all torcheval_tpu_torch metrics.

    Subclasses register states with ``_add_state`` in ``__init__`` and
    implement ``update``/``compute``; ``merge_state`` is derived from the
    registered merge kinds unless overridden.
    """

    def __init__(self, *, device: DeviceLike = None, shard: Optional[Any] = None) -> None:
        self._state_name_to_default: Dict[str, TState] = {}
        self._state_name_to_merge_kind: Dict[str, MergeKind] = {}
        self._device: torch.device = canonicalize_device(device)
        # sharded state (metrics/shardspec.py): `shard` is this instance's
        # ShardContext; `_sharded_states` the ShardInfo a sharded state,
        # `_routed_states` the outbox names of routed ones
        self._shard_ctx = shard
        self._sharded_states: Dict[str, Any] = {}
        self._routed_states: Dict[str, Any] = {}
        self._shard_bookkeeping_registered = False

    def __init_subclass__(cls, **kwargs: Any) -> None:
        """Instrument a concrete ``update``/``compute`` defined on this
        class (``_instrumented``: observability, and the donation shield
        on ``compute``); inherited ones were wrapped where they were
        defined. Abstract stubs are left alone, and wrapping is
        idempotent."""
        super().__init_subclass__(**kwargs)
        for name in ("update", "compute"):
            fn = cls.__dict__.get(name)
            if (
                fn is None
                or not callable(fn)
                or getattr(fn, "__isabstractmethod__", False)
                or getattr(fn, "_obs_instrumented", False)
            ):
                continue
            setattr(cls, name, _instrumented(fn, name, cls.__name__))

    # Donation: while True -- and ``config.update_donation_enabled`` holds
    # for this metric's device (on for CUDA by default) -- updates write
    # each new state into the live state tensor in place. State tensors
    # must therefore never escape the metric: ``state_dict`` copies,
    # ``compute`` results are shielded. A subclass whose states alias
    # outside tensors opts out by setting this False.
    _donated_update: bool = True

    def _donation_active(self) -> bool:
        return self._donated_update and config.update_donation_enabled(self._device)

    # class-level fallbacks, so instances that skipped ``__init__`` (and
    # pickles of replicated metrics) read as replicated. Read-only
    # mappings: a write through such an instance raises instead of landing
    # on the class and making every metric "sharded".
    _shard_ctx = None
    _sharded_states: Dict[str, Any] = types.MappingProxyType({})
    _routed_states: Dict[str, Any] = types.MappingProxyType({})
    _shard_bookkeeping_registered = False

    # CUSTOM states that must ALSO merge in the sharded reassembly, which
    # otherwise keeps CUSTOM non-sharded states at self's value (the
    # rank-identical configuration scalars): obs/quality.py lists the
    # input sketches' moments here.
    _custom_mergeable_states: frozenset = frozenset()

    # Bumped by ``reset()`` and ``load_state_dict``: a sync plane
    # (``syncplane.SyncPlane``) discards a snapshot published at an older
    # epoch, so a read after a reset never serves pre-reset merged values.
    # Updates never touch it. A class-level default, so pickles and clones
    # that predate the field read 0.
    _state_epoch: int = 0

    # ------------------------------------------------------------------ state

    @property
    def device(self) -> torch.device:
        return self._device

    def _add_state(
        self,
        name: str,
        default: TState,
        *,
        merge: MergeKind = MergeKind.CUSTOM,
        shard: Optional[Any] = None,
    ) -> None:
        """Register a state variable. ``default`` is a tensor, a list of
        tensors, a dict with tensor values, an int, or a float; it is
        snapshotted for ``reset()`` and the live value (an independent
        copy) is placed on ``self.device``.

        ``shard`` (a ``shardspec.ShardSpec``) declares the state
        partitioned over the metric's shard context: the registered default
        becomes this rank's slice of axis 0 (only axis 0 shards), and that
        slice is what snapshots and syncs ship. Without a shard context it
        is ignored, so one class serves replicated and sharded use."""
        if shard is not None and self._shard_ctx is not None:
            if not isinstance(default, torch.Tensor):
                raise TypeError(f"sharded state {name!r} requires an array default")
            if shard.axis != 0:
                raise ValueError(
                    "eager sharding currently partitions axis 0 only "
                    f"(state {name!r} declared axis {shard.axis})"
                )
            default, info = self._shard_ctx.prepare_state(name, default, shard)
            self._sharded_states[name] = info
            self._ensure_shard_bookkeeping()
        self._check_state_variable_type(name, default)
        self._state_name_to_default[name] = _clone_state(default)
        self._state_name_to_merge_kind[name] = merge
        setattr(self, name, self._place_state(_clone_state(default)))

    def _ensure_shard_bookkeeping(self) -> None:
        """Register ``_shard_rank``/``_shard_world`` once a sharded metric:
        which shard the live tensors hold (this rank's own normally;
        ``-1``/``0`` after a reassembling merge made the instance logical).
        They are plain int states, so snapshots and sync payloads describe
        themselves."""
        ctx = self._shard_ctx
        if ctx is None or self._shard_bookkeeping_registered:
            return
        self._shard_bookkeeping_registered = True
        self._add_state("_shard_rank", int(ctx.rank), merge=MergeKind.CUSTOM)
        self._add_state("_shard_world", int(ctx.world), merge=MergeKind.CUSTOM)

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
        """The update factored as a plan -- an :class:`UpdatePlan`, or the
        tuple ``(kernel, state_names, dynamic[, config])`` that stands for
        ``UpdatePlan(kernel, state_names, dynamic, config)`` -- or ``None``
        when the update is not expressed as one. Whoever takes a plan from
        a metric reads it through :func:`as_update_plan`. Implementations
        validate their inputs here, so a returned plan is safe to run;
        ``toolkit.update_collection`` builds every metric's plan before it
        runs any of them."""
        return None

    def _apply_update_plan(self: TSelf, plan) -> TSelf:
        """Run one update plan against this metric's states through the
        plan runner of ``metrics/_fuse.py``, as ``update_collection`` runs
        a panel's: bucketed first when it declares a masked kernel, one
        CUDA-graph replay when bucketed on CUDA under donation, eager
        otherwise (an unbucketed plan never graphs here), then its
        ``finalize``."""
        from torcheval_tpu_torch.metrics._fuse import prepare_plan, run_plans

        run_plans([prepare_plan(self, plan)], repeat_graphs=False)
        return self

    @abstractmethod
    def compute(self) -> TComputeReturn:
        """Finalize the metric value from state. Idempotent."""

    # ------------------------------------------------------------------ merge

    def merge_state(self: TSelf, metrics: Iterable[TSelf]) -> TSelf:
        """Merge peer replicas' states into self, by the registered merge
        kinds, one peer at a time in the order given. A shard carrier
        (``Metric(shard=...)``) reassembles the logical state from its
        peers' shards instead (``_merge_sharded``)."""
        metrics = list(metrics)
        if self._sharded_states and self._is_shard_carrier():
            return self._merge_sharded(metrics)
        for other in metrics:
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

    # ----------------------------------------------------------- sharded state

    def _is_shard_carrier(self) -> bool:
        """True while the live sharded states hold ONE rank's slice; False
        on replicated instances and after a reassembling merge made the
        instance logical."""
        return bool(self._sharded_states) and int(getattr(self, "_shard_world", 0)) > 0

    def _own_shard_active(self) -> bool:
        """True when the live states hold this rank's configured shard, the
        precondition of the sharded update plans. A carrier of a FOREIGN
        shard (a sync or restore clone) must not be updated; a logical
        instance updates through the dense plans."""
        if not self._is_shard_carrier():
            return False
        ctx = self._shard_ctx
        if ctx is None:
            return False
        rk = int(getattr(self, "_shard_rank"))
        wd = int(getattr(self, "_shard_world"))
        if rk == ctx.rank and wd == ctx.world:
            return True
        raise RuntimeError(
            f"{type(self).__name__} holds shard {rk} of world {wd} but is "
            f"configured as rank {ctx.rank} of world {ctx.world}; foreign "
            "shard carriers are merge/sync intermediates and cannot be "
            "updated"
        )

    def _route_active(self, name: str) -> bool:
        """Whether ``update()`` takes the routed plan for ``name``: routed,
        this rank's own shard live, and a world above 1 (at world 1 every
        cell is owned, and the dense plan is the better one)."""
        return (
            name in self._routed_states
            and self._shard_ctx is not None
            and self._shard_ctx.world > 1
            and self._own_shard_active()
        )

    def _carried(self, carrier) -> tuple:
        return int(getattr(carrier, "_shard_rank", -1)), int(getattr(carrier, "_shard_world", 0))

    def _merge_sharded(self: TSelf, metrics: List[TSelf]) -> TSelf:
        """Reassemble the logical state from shard carriers: ``self`` and
        every peer carry one rank's slice (named by their
        ``_shard_rank``/``_shard_world``). Each sharded state: every
        carrier's slice added into a fresh logical tensor, then every
        carrier's outbox applied in ascending carried-rank order; counters
        are integers, so the result equals the replicated merge bitwise.
        Other states merge by their kinds, but CUSTOM ones keep ``self``'s
        value (rank-identical configuration) unless listed in
        ``_custom_mergeable_states``. Afterwards ``self`` is logical
        (``_shard_rank == -1``)."""
        from torcheval_tpu_torch.metrics import shardspec

        carriers = sorted([self] + list(metrics), key=lambda c: self._carried(c)[0])
        worlds = {self._carried(c)[1] for c in carriers} - {0}
        if len(worlds) > 1:
            raise RuntimeError(
                f"cannot merge shard carriers from different worlds {sorted(worlds)}"
            )
        merged: Dict[str, torch.Tensor] = {}
        for name, info in self._sharded_states.items():
            names = self._routed_states.get(name)
            if names is not None and names.is_value_lane:
                merged[name] = self._merge_value_routed_state(name, info, names, carriers)
                continue
            logical = torch.zeros(info.logical_shape, dtype=info.dtype, device=self._device)
            for c in carriers:
                value = self._place_state(getattr(c, name))
                rk, wd = self._carried(c)
                if rk < 0 or wd <= 0:
                    # an already-logical carrier folds in whole
                    logical += value
                    continue
                start, stop = self._shard_ctx.shard_range(info.logical_shape[0], rk, wd)
                logical[start:stop] += value
            if names is not None:
                flat = logical.view(-1)
                for c in carriers:
                    cnt = int(getattr(c, names.obh, 0))
                    shardspec.apply_outbox_counts(flat, getattr(c, names.obi)[:cnt])
            merged[name] = logical
        skip = set(self._sharded_states) | self._routed_aux_names()
        skip.update(("_shard_rank", "_shard_world"))
        for other in carriers:
            if other is self:
                continue
            for name, kind in self._state_name_to_merge_kind.items():
                if name in skip or (
                    kind is MergeKind.CUSTOM and name not in self._custom_mergeable_states
                ):
                    continue
                mine = getattr(self, name)
                theirs = self._place_state(getattr(other, name))
                setattr(self, name, self._merge_one(name, kind, mine, theirs))
        for name, value in merged.items():
            setattr(self, name, value)
        self._clear_outboxes()
        self._shard_rank = -1
        self._shard_world = 0
        return self

    def _value_lane_contribution(self, carrier, name, info, names, logical) -> torch.Tensor:
        """``logical`` plus one carrier's float-lane outbox, folded a batch
        at a time (``shardspec.apply_outbox_values``)."""
        from torcheval_tpu_torch.metrics import shardspec

        cnt = int(getattr(carrier, names.obh, 0))
        if not cnt:
            return logical
        nb = int(getattr(carrier, names.obbh, 0))
        bounds = shardspec.complete_bounds(getattr(carrier, names.obb)[:nb].tolist(), cnt)
        col = names.states.index(name)
        return shardspec.apply_outbox_values(
            logical.reshape(-1),
            self._place_state(getattr(carrier, names.obi))[:cnt],
            self._place_state(getattr(carrier, names.obv))[:cnt, col],
            bounds,
        ).reshape(info.logical_shape)

    def _merge_value_routed_state(self, name: str, info, names, carriers) -> torch.Tensor:
        """One float-lane state's reassembly: the sum over carriers, in
        carried-rank order, of each carrier's slice placed in a fresh
        logical tensor plus its outbox folded a batch at a time."""
        logical = torch.zeros(info.logical_shape, dtype=info.dtype, device=self._device)
        for c in carriers:
            value = self._place_state(getattr(c, name))
            rk, wd = self._carried(c)
            if rk < 0 or wd <= 0:
                contrib = value
            else:
                start, stop = self._shard_ctx.shard_range(info.logical_shape[0], rk, wd)
                contrib = torch.zeros(info.logical_shape, dtype=info.dtype, device=self._device)
                contrib[start:stop] = value
                contrib = self._value_lane_contribution(c, name, info, names, contrib)
            logical = logical + contrib
        return logical

    def _routed_aux_names(self) -> set:
        out = set()
        for names in self._routed_states.values():
            out.update((names.obi, names.obn, names.obh))
            if names.is_value_lane:
                out.update((names.obv, names.obb, names.obc, names.obbh))
        return out

    def _empty_outboxes(self) -> Dict[str, TState]:
        """Every outbox state at its empty default, on ``self.device``."""
        out: Dict[str, TState] = {}
        for names in self._routed_states.values():
            out[names.obi] = torch.zeros((0,), dtype=torch.int32, device=self._device)
            out[names.obn] = torch.zeros((), dtype=torch.int32, device=self._device)
            out[names.obh] = 0
            if names.is_value_lane:
                out[names.obv] = torch.zeros(
                    (0, len(names.states)), dtype=torch.float32, device=self._device
                )
                out[names.obb] = torch.zeros((0,), dtype=torch.int32, device=self._device)
                out[names.obc] = torch.zeros((), dtype=torch.int32, device=self._device)
                out[names.obbh] = 0
        return out

    def _clear_outboxes(self) -> None:
        for name, value in self._empty_outboxes().items():
            setattr(self, name, value)

    def _logical_state(self, name: str) -> torch.Tensor:
        """The logically full view of one state: the live state on
        replicated and logical instances; on a shard carrier, its slice
        placed at the carried range plus its own outbox, exactly what this
        rank observed, so an un-synced ``compute()`` equals a replicated
        metric's local one. Not retained."""
        value = getattr(self, name)
        info = self._sharded_states.get(name) if self._sharded_states else None
        if info is None or not self._is_shard_carrier():
            return value
        from torcheval_tpu_torch.metrics import shardspec

        rk, wd = self._carried(self)
        start, stop = self._shard_ctx.shard_range(info.logical_shape[0], rk, wd)
        logical = torch.zeros(info.logical_shape, dtype=info.dtype, device=value.device)
        logical[start:stop] = value
        names = self._routed_states.get(name)
        if names is not None and names.is_value_lane:
            logical = self._value_lane_contribution(self, name, info, names, logical)
        elif names is not None:
            cnt = int(getattr(self, names.obh, 0))
            shardspec.apply_outbox_counts(logical.view(-1), getattr(self, names.obi)[:cnt])
        return logical

    def _reshard_to_own(self: TSelf) -> TSelf:
        """Re-slice a logical instance to this rank's configured shard, the
        last step of a world-size-change restore: the merge rebuilt the
        logical state from every old rank's shard and outbox, and each new
        rank keeps its slice (slices partition the cells)."""
        ctx = self._shard_ctx
        if not self._sharded_states or ctx is None:
            return self
        rk, wd = self._carried(self)
        if rk == ctx.rank and wd == ctx.world:
            return self
        if rk >= 0 and wd == 1:
            # a world-1 carrier's shard IS the logical state, and its
            # outboxes stay empty (every cell is owned)
            if any(int(getattr(self, n.obh, 0)) != 0 for n in self._routed_states.values()):
                raise RuntimeError(
                    "world-1 shard carrier has pending outbox entries; refusing to reshard"
                )
        elif rk >= 0:
            raise RuntimeError(
                "reshard requires a desharded (merged) logical state or "
                f"this rank's own shard; live state carries shard {rk} of "
                f"world {wd}"
            )
        for name, info in self._sharded_states.items():
            start, stop = ctx.shard_range(info.logical_shape[0])
            setattr(self, name, getattr(self, name)[start:stop].clone())
        self._clear_outboxes()
        self._shard_rank = ctx.rank
        self._shard_world = ctx.world
        return self

    def _adopt_shard_payload(self, state_dict: Dict[str, TState]) -> Dict[str, TState]:
        """Normalize an incoming snapshot for a sharded instance. A payload
        with ``_shard_rank >= 0`` is taken as is (the instance becomes that
        rank's carrier: sync clones, same-world restores). A LOGICAL payload
        (``_shard_rank == -1``, or no descriptor and logical shapes) is
        re-sliced to this rank's shard with empty outboxes: a merged result
        or a world-size-change restore landing in a working metric."""
        ctx = self._shard_ctx
        # payloads without outbox states (a replicated writer's) load into
        # a routed instance with empty ones
        for name, value in self._empty_outboxes().items():
            state_dict.setdefault(name, value)
        rk = state_dict.get("_shard_rank")
        if rk is None:
            # no descriptor: infer from shapes, all or nothing
            shapes = []
            for name, info in self._sharded_states.items():
                value = state_dict.get(name)
                if value is None:
                    continue
                shapes.append(
                    tuple(value.shape) == tuple(info.logical_shape)
                    and tuple(info.logical_shape) != tuple(getattr(self, name).shape)
                )
            logical = bool(shapes) and all(shapes)
        else:
            logical = int(rk) < 0
        if not logical:
            return state_dict
        for name, info in self._sharded_states.items():
            value = state_dict.get(name)
            if value is None:
                continue
            start, stop = ctx.shard_range(info.logical_shape[0])
            state_dict[name] = value[start:stop]
        state_dict["_shard_rank"] = ctx.rank
        state_dict["_shard_world"] = ctx.world
        state_dict.update(self._empty_outboxes())
        return state_dict

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
        # a provenance left by a prior (possibly degraded) sync, and the
        # step an update stamped, describe the state this reset discarded
        self.__dict__.pop("sync_provenance", None)
        self.__dict__.pop("obs_step", None)
        # ... and any published snapshot of it is stale now
        self._state_epoch = self._state_epoch + 1
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
        their capacity). A routed sharded metric ships each outbox cut to
        the power of two covering its entries, so its wire is the shard
        plus O(entries), never the capacity nor the logical state. Each
        state is cut before it is copied, and the cuts read the outboxes'
        host counters, so nothing here waits on the card.
        Checkpoints keep using ``state_dict()``."""
        keep: Dict[str, int] = {}
        for names in self._routed_states.values():
            cnt = int(getattr(self, names.obh, 0))
            n = 1 << (cnt - 1).bit_length() if cnt > 0 else 0
            for key in (names.obi, names.obv) if names.is_value_lane else (names.obi,):
                keep[key] = n
            if names.is_value_lane:
                nb = int(getattr(self, names.obbh, 0))
                keep[names.obb] = 1 << (nb - 1).bit_length() if nb > 0 else 0
        if type(self).state_dict is not Metric.state_dict:
            # a subclass adds to its snapshot: cut the copies it makes
            sd = self.state_dict()
            for name, n in keep.items():
                if sd[name].shape[0] > n:
                    sd[name] = sd[name][:n]
            return sd
        sd = {}
        for name in self._state_name_to_default:
            value = getattr(self, name)
            if name in keep and value.shape[0] > keep[name]:
                value = value[: keep[name]]
            sd[name] = _clone_state(value)
        return sd

    def load_state_dict(
        self, state_dict: Dict[str, TState], strict: bool = True
    ) -> None:
        """Load a snapshot; the metric keeps copies, never the caller's
        tensors. A sharded instance takes a shard carrier's snapshot as is,
        or re-slices a logical one to its own shard
        (``_adopt_shard_payload``)."""
        state_dict = dict(state_dict)
        if self._sharded_states and self._shard_ctx is not None:
            state_dict = self._adopt_shard_payload(state_dict)
        registered = set(self._state_name_to_default)
        provided = set(state_dict)
        if strict and registered != provided:
            raise RuntimeError(
                "Error(s) in loading state_dict for "
                f"{type(self).__name__}: "
                f"missing keys: {sorted(registered - provided)}, "
                f"unexpected keys: {sorted(provided - registered)}."
            )
        donate = self._donation_active()
        for name in registered & provided:
            value = state_dict[name]
            self._check_state_variable_type(name, value)
            live = getattr(self, name, None)
            if (
                donate
                and isinstance(live, torch.Tensor)
                and isinstance(value, torch.Tensor)
                and live.dtype == value.dtype
                and live.shape == value.shape
                and live.device == self._device
            ):
                # as reset() does: the live tensor, and the CUDA graphs
                # that write it, outlive the load
                live.copy_(value, non_blocking=True)
            else:
                setattr(self, name, self._place_state(_clone_state(value)))
        # restored state replaces whatever a prior sync produced; the sync
        # path stamps its own provenance afterwards
        self.__dict__.pop("sync_provenance", None)
        self.__dict__.pop("obs_step", None)
        self._state_epoch = self._state_epoch + 1

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
