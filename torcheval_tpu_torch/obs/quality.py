"""Input-quality watching and drift scoring (data-quality telemetry).

Counterpart of ``torcheval_tpu/obs/quality.py`` with the same names.
:func:`watch_inputs` arms data observability on a metric (or a
``{name: Metric}`` collection): the four sketch state families of
:class:`~torcheval_tpu_torch.obs.sketch.InputSketch` are registered as
ordinary states ON the watched metric (``_add_state``, so they ride sync,
merge, elastic snapshots and the sharded reassembly), and the metric's
update plan is extended so the sketch fold runs inside the same update:

- **one update**: the combined kernel runs the metric's own kernel, then
  one sketch fold a watched argument, as one transform plan
  (``metrics/_fuse.py``); under shape bucketing on the card that is one
  CUDA-graph replay, as the unwatched update is;
- **no collective, no host sync** on the update path;
- **one attribute read off**: accumulation is gated on
  ``QUALITY.enabled``; paused, a watched ``_update_plan`` costs one
  attribute read over the unwatched one;
- **masked twins**: when the watched plan declares a masked kernel, the
  combined plan does too, and padded rows add nothing to any sketch state.

:class:`DriftSpec` scores the live sketches against a frozen reference at
``Monitor.check()`` cadence (the health server runs it per ``/healthz``
probe): population-stability index (PSI) and histogram KS over the
quantile histogram with the below/above lanes, and a Welch z on the
means, all on the POST-FREEZE window (SUM states subtract exactly; the
moments window is the exact Chan-merge inverse). Breaches raise monitor
alerts (``/healthz`` 503) and every scored check records a
:class:`~torcheval_tpu_torch.obs.events.DriftEvent` while the recorder is
on. The ``quality`` counter source publishes per-input gauges, and
``render_prometheus`` adds the value histograms as ``histogram``
families.

A breach is also the measured error budget of the quantized wire
ladder: the watched metric's family forfeits one lossy rung
(``wire.note_budget_breach``: int8 -> bf16 -> exact, with a
``WireTierEvent`` at each step).

Cost contract: the step path never reads a device value; scoring,
scraping and ``freeze_reference`` read the small sketch states back.
"""

from __future__ import annotations

import math
import threading
import types
import weakref
from functools import lru_cache
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from torcheval_tpu_torch.metrics._fuse import _add
from torcheval_tpu_torch.metrics.metric import MergeKind, Metric, UpdatePlan, as_update_plan
from torcheval_tpu_torch.obs.sketch import (
    _CNT_ABOVE,
    _CNT_BELOW,
    CNT_FIELDS,
    InputSketch,
    SketchConfig,
    _fold,
    _host,
    _row_weights,
    chan_merge,
    default_config,
    hll_estimate,
    moment_default,
    moments_window,
)

__all__ = [
    "DriftSpec",
    "QUALITY",
    "QualityWatch",
    "active_watches",
    "watch_inputs",
]

_STATE_SUFFIXES = ("hist", "cnt", "mom", "reg")

# per-metric extended-plan memo (see _watched_update_plan); weak keys, so
# a dropped metric never pins its plan or the kernels it closes over
_PLAN_MEMO: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()  # tev: disable=unguarded-state -- keyed by the metric instance whose own (single-threaded) update call populates it; no cross-thread sharing by contract


def _q_names(i: int) -> Tuple[str, ...]:
    return tuple(f"_q{i}_{s}" for s in _STATE_SUFFIXES)


class _QualityState:
    """The one-attribute-read accumulation gate: watched metrics extend
    their update plans only while ``enabled`` is True. Watching is the
    explicit opt-in, so it defaults on; pause it to measure or bypass
    accumulation without un-watching."""

    __slots__ = ("enabled",)

    def __init__(self) -> None:
        self.enabled = True


QUALITY = _QualityState()


class DriftSpec(NamedTuple):
    """Drift bounds for one watched input (``series="*"``: all of them),
    scored on the post-freeze window against the frozen reference:
    ``psi`` bounds the population-stability index (0.1 moderate, 0.2
    significant by the usual rule), ``ks`` the largest CDF distance, ``z``
    the absolute Welch z of the window mean against the reference mean.
    ``min_count`` gates scoring until the window holds that many finite
    samples."""

    series: str = "*"
    psi: float = 0.2
    ks: float = 0.2
    z: float = 6.0
    min_count: int = 256


class _WatchSpec(NamedTuple):
    """Per-metric instrumentation record (hashable)."""

    args: Tuple[int, ...]
    sketch: SketchConfig


# ------------------------------------------------------ combined kernels


def _normalize(out: Any, n: int, kernel: Any) -> Tuple:
    if not isinstance(out, tuple):
        out = (out,)
    if len(out) != n:
        raise ValueError(
            f"kernel {getattr(kernel, '__name__', kernel)} returned "
            f"{len(out)} values for {n} states"
        )
    return out


@lru_cache(maxsize=None)
def _combined_kernels(
    orig_kernel,
    orig_masked,
    transform: bool,
    n_orig: int,
    orig_config: Tuple,
    arg_indices: Tuple[int, ...],
    cfg: SketchConfig,
    mask_pos: Tuple[int, ...],
):
    """(plain, masked) transform kernels running the watched metric's own
    kernel and one sketch fold a watched dynamic argument. Cached per
    (kernel, config, watch geometry), so the kernel objects, and with them
    the CUDA-graph keys, stay the same across updates. ``mask_pos[k]`` is
    the slot of watched argument k's batch label in the bucketed valid
    vector (-1: no ragged axis, every row valid)."""

    def _orig_part(states, dyn, kernel, extra=()):
        orig_states = states[:n_orig]
        if transform:
            return _normalize(kernel(orig_states, *dyn, *extra, *orig_config), n_orig, kernel)
        deltas = _normalize(kernel(*dyn, *extra, *orig_config), n_orig, kernel)
        return tuple(_add(s, d) for s, d in zip(orig_states, deltas))

    def _sketch_part(states, dyn, weights):
        out = []
        for k, i in enumerate(arg_indices):
            s4 = states[n_orig + 4 * k : n_orig + 4 * (k + 1)]
            x = dyn[i]
            if not isinstance(x, torch.Tensor):
                # a host int operand (a windowed plan's ring cursor, which
                # the JAX package passes as an int32 device scalar): one
                # fill, no upload
                x = torch.full((), x, dtype=torch.int32, device=s4[0].device)
            out.extend(_fold(cfg, s4, x, weights[k]))
        return tuple(out)

    def plain(states, *dyn):
        ones = tuple(
            torch.ones((), dtype=torch.float32, device=states[n_orig].device)
            for _ in arg_indices
        )
        return _orig_part(states, dyn, orig_kernel) + _sketch_part(states, dyn, ones)

    masked = None
    if orig_masked is not None:

        def masked(states, *args):
            dyn, valid = args[:-1], args[-1]
            weights = []
            for k, i in enumerate(arg_indices):
                pos = mask_pos[k]
                if pos < 0:
                    weights.append(torch.ones((), dtype=torch.float32, device=dyn[i].device))
                else:
                    weights.append(_row_weights(dyn[i], valid[pos]))
            # the original masked kernel keeps its own (*dyn, valid)
            # signature; the sketch folds read the same valid vector
            return _orig_part(states, dyn, orig_masked, (valid,)) + _sketch_part(
                states, dyn, tuple(weights)
            )

        masked.__name__ = f"{getattr(orig_masked, '__name__', 'kernel')}_q"

    plain.__name__ = f"{getattr(orig_kernel, '__name__', 'kernel')}_q"
    return plain, masked


def _extend_plan(plan, spec: _WatchSpec):
    """The quality-watched twin of one update plan: the same dynamic
    arguments, the original states first and four sketch states a watched
    argument after them, one combined transform kernel (and a masked twin
    when the original has one)."""
    bad = [i for i in spec.args if i >= len(plan.dynamic)]
    if bad:
        raise ValueError(
            f"watch_inputs args {bad} are out of range for this "
            f"metric's update plan ({len(plan.dynamic)} dynamic "
            "argument(s)) — watched indices name positional update "
            "arguments"
        )
    order: List[str] = []
    for labels in plan.batch_axes:
        for label in labels or ():
            if label not in order:
                order.append(label)
    mask_pos = []
    for i in spec.args:
        labels = (plan.batch_axes[i] if i < len(plan.batch_axes) else ()) or ()
        mask_pos.append(order.index(labels[0]) if labels else -1)
    combined, combined_masked = _combined_kernels(
        plan.kernel,
        plan.masked_kernel,
        plan.transform,
        len(plan.state_names),
        plan.config,
        spec.args,
        spec.sketch,
        tuple(mask_pos),
    )
    state_names = plan.state_names + tuple(name for i in spec.args for name in _q_names(i))
    return UpdatePlan(
        combined,
        state_names,
        plan.dynamic,
        (),
        transform=True,
        finalize=plan.finalize,
        masked_kernel=combined_masked,
        batch_axes=plan.batch_axes if combined_masked is not None else (),
    )


# module-level functions (not closures), so the bound-method instance
# attributes survive deepcopy (a clone rebinds to the copy) and pickling
def _watched_update_plan(self, *args: Any, **kwargs: Any):
    plan = type(self)._update_plan(self, *args, **kwargs)
    if plan is None or not QUALITY.enabled:  # the one-attribute-read gate
        return plan
    plan = as_update_plan(plan, self)
    # a metric's plan shape is stable across updates: memoize the rewrite
    # per metric, keyed on every field it depends on, and swap in only the
    # per-call dynamic tuple and finalize. The memo lives off the instance
    # (the rewritten plan holds kernel closures; instance state stays
    # deepcopy- and pickle-clean).
    memo_key = (
        plan.kernel,
        plan.masked_kernel,
        plan.state_names,
        plan.config,
        plan.transform,
        plan.batch_axes,
    )
    memo = _PLAN_MEMO.get(self)
    if memo is not None and memo[0] == memo_key:
        return memo[1]._replace(dynamic=plan.dynamic, finalize=plan.finalize)
    extended = _extend_plan(plan, self._quality_spec)
    _PLAN_MEMO[self] = (memo_key, extended._replace(dynamic=(), finalize=None))
    return extended


def _watched_merge_custom(self, name: str, mine, theirs):
    if name.startswith("_q") and name.endswith("_mom"):
        # the merge loop left-folds peers in order: Chan's merge pairwise
        # in carrier (ascending rank) order (obs/sketch.py)
        return chan_merge(mine, theirs)
    return type(self)._merge_custom_state(self, name, mine, theirs)


def _validate_watchable(metric: Metric) -> None:
    """The checks before instrumenting, apart, so a collection watch
    validates every member before instrumenting any."""
    if getattr(metric, "_quality_spec", None) is not None:
        raise ValueError(f"{type(metric).__name__} is already quality-watched")
    if type(metric)._update_plan is Metric._update_plan:
        raise TypeError(
            f"watch_inputs requires a metric with a fusable update plan "
            f"({type(metric).__name__} has none — buffered/host-side "
            "updates cannot fuse sketch accumulation)"
        )


def _instrument(metric: Metric, spec: _WatchSpec) -> None:
    _validate_watchable(metric)
    cfg = spec.sketch
    for i in spec.args:
        h, c, m, r = _q_names(i)
        metric._add_state(h, torch.zeros((cfg.num_bins,), dtype=torch.float32), merge=MergeKind.SUM)
        metric._add_state(c, torch.zeros((8,), dtype=torch.int32), merge=MergeKind.SUM)
        metric._add_state(m, moment_default(), merge=MergeKind.CUSTOM)
        metric._add_state(r, torch.zeros((cfg.registers,), dtype=torch.int32), merge=MergeKind.MAX)
    metric._quality_spec = spec
    # the moments must ALSO merge in the sharded reassembly, which keeps
    # CUSTOM non-sharded states at self's value unless listed here
    metric._custom_mergeable_states = frozenset(metric._custom_mergeable_states) | {
        _q_names(i)[2] for i in spec.args
    }
    metric._update_plan = types.MethodType(_watched_update_plan, metric)
    metric._merge_custom_state = types.MethodType(_watched_merge_custom, metric)


# --------------------------------------------------------------- watching

_WATCHES: "Dict[int, QualityWatch]" = {}  # tev: guarded-by=_WATCH_LOCK
_WATCH_LOCK = threading.Lock()
_WATCH_SEQ = [0]  # tev: guarded-by=_WATCH_LOCK


def active_watches() -> List["QualityWatch"]:
    """The live :class:`QualityWatch` handles (the exporters iterate
    them)."""
    with _WATCH_LOCK:
        return list(_WATCHES.values())


def _quality_counters() -> Dict[str, Any]:
    out: Dict[str, Any] = {"watched_inputs": 0}
    for watch in active_watches():
        counters = watch.counters()
        out["watched_inputs"] += counters.pop("watched_inputs", 0)
        out.update(counters)
    return out


def _check_watches(monitor) -> List[Dict[str, Any]]:
    raised: List[Dict[str, Any]] = []
    for watch in active_watches():
        raised.extend(watch.check(monitor))
    return raised


def _register_global_hooks() -> None:
    from torcheval_tpu_torch.obs.counters import default_registry
    from torcheval_tpu_torch.obs.monitor import register_check_hook

    default_registry().register("quality", _quality_counters)
    register_check_hook("quality", _check_watches)


def _unregister_global_hooks() -> None:
    from torcheval_tpu_torch.obs.counters import default_registry
    from torcheval_tpu_torch.obs.monitor import unregister_check_hook

    default_registry().unregister("quality")
    unregister_check_hook("quality")


def watch_inputs(
    metric_or_collection,
    *,
    args: Tuple[int, ...] = (0,),
    num_bins: Optional[int] = None,
    bounds: Optional[Tuple[float, float]] = None,
    log2_bounds: Tuple[int, int] = (-24, 24),
    registers: int = 64,
    label: Optional[str] = None,
) -> "QualityWatch":
    """Arm input-quality sketches on a metric or a ``{name: Metric}``
    collection (the module docstring has the cost contract).

    ``args`` names the watched positional update arguments (default: the
    first, conventionally the prediction); the sketch geometry knobs are
    :class:`~torcheval_tpu_torch.obs.sketch.InputSketch`'s. Each watched
    input is a series ``<label>/<arg index>`` (collection members use
    their key). Returns the :class:`QualityWatch` handle: reference
    freezing, drift specs, sketch snapshots, ``close()``."""
    cfg = default_config(num_bins, bounds, log2_bounds, registers)
    args = tuple(sorted(set(int(i) for i in args)))
    if not args or any(i < 0 for i in args):
        raise ValueError(f"args must be non-negative indices, got {args!r}")
    spec = _WatchSpec(args=args, sketch=cfg)
    if isinstance(metric_or_collection, dict):
        members = list(metric_or_collection.items())
        if not members:
            raise ValueError("watch_inputs: empty collection")
    else:
        members = [(label or type(metric_or_collection).__name__, metric_or_collection)]
    entries = []
    for name, metric in members:
        _validate_watchable(metric)
        for i in args:
            entries.append((f"{name}/{i}", metric, i))
    # series names are unique ACROSS watches: a collision would merge two
    # inputs' gauges and let one watch clear the other's drift alert
    with _WATCH_LOCK:
        taken = {series for other in _WATCHES.values() for series in other.series}
    clashes = sorted({s for s, _, _ in entries} & taken)
    if clashes:
        raise ValueError(
            f"watch series {clashes} already exist on an active watch; "
            "pass label= (or distinct collection keys) to disambiguate"
        )
    for name, metric in members:
        _instrument(metric, spec)
    watch = QualityWatch(entries, cfg)
    with _WATCH_LOCK:
        _WATCH_SEQ[0] += 1
        watch._id = _WATCH_SEQ[0]
        _WATCHES[watch._id] = watch
        _register_global_hooks()
    return watch


class QualityWatch:
    """Handle over a set of watched inputs, one a (metric, arg); series
    keys are ``<label>/<arg index>``. The reading methods (``sketch``,
    ``score``, ``counters``, ``check``) read the sketch states back:
    scrape or check cadence only."""

    def __init__(self, entries, config: SketchConfig) -> None:
        self._entries: Dict[str, Tuple[Metric, int]] = {
            series: (metric, arg) for series, metric, arg in entries
        }
        self.config = config
        self._id = 0
        self._lock = threading.Lock()
        self._refs: Dict[str, Dict[str, np.ndarray]] = {}  # tev: guarded-by=_lock
        self._specs: List[DriftSpec] = []  # tev: guarded-by=_lock
        self._scores: Dict[str, Dict[str, float]] = {}  # tev: guarded-by=_lock

    @property
    def series(self) -> Tuple[str, ...]:
        return tuple(sorted(self._entries))

    def _states(self, series: str) -> Dict[str, np.ndarray]:
        metric, arg = self._entries[series]
        h, c, m, r = _q_names(arg)
        return {
            "hist": _host(getattr(metric, h)),
            "cnt": _host(getattr(metric, c)),
            "mom": _host(getattr(metric, m)),
            "reg": _host(getattr(metric, r)),
        }

    def sketch(self, series: str) -> InputSketch:
        """A standalone :class:`InputSketch` loaded from one watched
        input's live states (an independent snapshot, on the metric's
        device)."""
        metric, arg = self._entries[series]
        cfg = self.config
        if cfg.log2:
            sk = InputSketch(
                num_bins=cfg.num_bins,
                log2_bounds=(int(cfg.lo), int(cfg.hi)),
                registers=cfg.registers,
                device=metric.device,
            )
        else:
            sk = InputSketch(
                num_bins=cfg.num_bins,
                bounds=(cfg.lo, cfg.hi),
                registers=cfg.registers,
                device=metric.device,
            )
        h, c, m, r = _q_names(arg)
        sk.load_state_dict(
            {
                "hist": getattr(metric, h),
                "counts": getattr(metric, c),
                "moments": getattr(metric, m),
                "registers": getattr(metric, r),
            }
        )
        return sk

    # ----------------------------------------------------------- drift

    def freeze_reference(self) -> None:
        """Snapshot every watched input's live sketch as the drift
        reference; scoring compares the window after it. Call it after
        the reference traffic (and again to re-baseline)."""
        refs = {series: self._states(series) for series in self._entries}
        with self._lock:
            self._refs = refs

    def add_drift(self, *specs: DriftSpec) -> None:
        """Arm drift scoring: freezes a reference now if none exists and
        registers the specs (``series="*"``: every watched input). Scoring
        runs inside ``Monitor.check()``."""
        specs = specs or (DriftSpec(),)
        for spec in specs:
            if spec.series != "*" and spec.series not in self._entries:
                raise KeyError(
                    f"DriftSpec series {spec.series!r} is not watched "
                    f"(watched: {sorted(self._entries)})"
                )
        with self._lock:
            need_ref = not self._refs
            self._specs.extend(specs)
        if need_ref:
            self.freeze_reference()

    def _series_specs(self) -> Dict[str, DriftSpec]:
        with self._lock:
            specs = list(self._specs)
        out: Dict[str, DriftSpec] = {}
        for spec in specs:
            if spec.series == "*":
                for series in self._entries:
                    out.setdefault(series, spec)
            else:
                out[spec.series] = spec
        return out

    def score(self, series: str) -> Optional[Dict[str, float]]:
        """PSI / KS / z of the post-freeze window against the frozen
        reference (``None`` with no reference for ``series``)."""
        with self._lock:
            ref = self._refs.get(series)
        if ref is None:
            return None
        return _drift_scores(self._states(series), ref)

    def check(self, monitor) -> List[Dict[str, Any]]:
        """Score every specced series, raise monitor alerts for breaches
        and record a DriftEvent a scored series (recorder on). Called by
        ``Monitor.check`` through the quality check hook."""
        from torcheval_tpu_torch.obs.events import DriftEvent
        from torcheval_tpu_torch.obs.recorder import RECORDER

        raised: List[Dict[str, Any]] = []
        for series, spec in sorted(self._series_specs().items()):
            scores = self.score(series)
            if scores is None:
                continue
            with self._lock:
                self._scores[series] = scores
            if scores["count"] < spec.min_count:
                # a re-baseline shrinks the window below the gate: the
                # OLD window's standing alerts must clear
                for kind in ("psi", "ks", "z"):
                    monitor._clear(f"quality/{series}", f"drift-{kind}")
                continue
            breaches = []
            for kind, bound in (("psi", spec.psi), ("ks", spec.ks), ("z", spec.z)):
                value = abs(scores[kind])
                name = f"quality/{series}"
                if bound > 0 and value >= bound:
                    breaches.append(kind)
                    alert = monitor._alert(
                        name,
                        f"drift-{kind}",
                        scores[kind],
                        bound,
                        f"{series} input drift: {kind}={scores[kind]:.4g} "
                        f"breaches bound {bound:g} over a "
                        f"{scores['count']:.0f}-sample window "
                        f"(ref {scores['ref_count']:.0f})",
                    )
                    if alert:
                        raised.append(alert)
                else:
                    monitor._clear(name, f"drift-{kind}")
            if breaches:
                # a drifting input's family forfeits its lossy wire rung:
                # step it toward exact (a no-op once exact)
                from torcheval_tpu_torch import wire

                metric, _arg = self._entries[series]
                wire.note_budget_breach(
                    type(metric).__name__, series=series, breach=",".join(breaches)
                )
            RECORDER.record(
                DriftEvent(
                    series=series,
                    count=float(scores["count"]),
                    ref_count=float(scores["ref_count"]),
                    psi=float(scores["psi"]),
                    ks=float(scores["ks"]),
                    z=float(scores["z"]),
                    breach=",".join(breaches),
                )
            )
        return raised

    # -------------------------------------------------------- counters

    def counters(self) -> Dict[str, Any]:
        """The ``quality`` counter-source payload: per-series gauges (a
        readback: scrape cadence) with the last drift scores and breach
        flags."""
        out: Dict[str, Any] = {"watched_inputs": len(self._entries)}
        with self._lock:
            scores = dict(self._scores)
        specs = self._series_specs()
        for series in self.series:
            s = self._states(series)
            mom = s["mom"].astype(np.float64)
            cnt = s["cnt"]
            key = series
            count = float(mom[0])
            out[f"{key}_count"] = count
            out[f"{key}_mean"] = float(mom[1]) if count else 0.0
            out[f"{key}_std"] = math.sqrt(max(float(mom[2]) / count, 0.0)) if count else 0.0
            for lane, field in enumerate(CNT_FIELDS):
                if field in ("total", "nan", "posinf", "neginf", "zero", "negative"):
                    out[f"{key}_{field}"] = int(cnt[lane])
            out[f"{key}_distinct"] = hll_estimate(s["reg"])
            sc = scores.get(series)
            if sc is not None:
                out[f"{key}_psi"] = sc["psi"]
                out[f"{key}_ks"] = sc["ks"]
                out[f"{key}_z"] = sc["z"]
                spec = specs.get(series)
                if spec is not None:
                    for kind in ("psi", "ks", "z"):
                        bound = getattr(spec, kind)
                        out[f"{key}_breach_{kind}"] = int(
                            bound > 0 and abs(sc[kind]) >= bound and sc["count"] >= spec.min_count
                        )
        return out

    def close(self) -> None:
        """Detach this watch from the exporters and the check hook (the
        sketch states stay on the watched metrics: removing states would
        break strict snapshot loads). The emptiness check and the
        unregister happen under one lock hold."""
        with _WATCH_LOCK:
            _WATCHES.pop(self._id, None)
            if not _WATCHES:
                _unregister_global_hooks()


def _drift_scores(live: Dict[str, np.ndarray], ref: Dict[str, np.ndarray]) -> Dict[str, float]:
    """PSI, histogram KS and Welch z of the post-freeze window against the
    reference. Window lanes: [below, bin_0..bin_{B-1}, above], so a shift
    past the edges shows."""

    def lanes(s):
        return np.concatenate(
            (
                [float(s["cnt"][_CNT_BELOW])],
                np.asarray(s["hist"], np.float64),
                [float(s["cnt"][_CNT_ABOVE])],
            )
        )

    ref_lanes = lanes(ref)
    win_lanes = lanes(live) - ref_lanes
    mom_w = moments_window(live["mom"], ref["mom"])
    mom_r = np.asarray(ref["mom"], np.float64)
    n_w, n_r = float(mom_w[0]), float(mom_r[0])
    out = {"count": n_w, "ref_count": n_r, "psi": 0.0, "ks": 0.0, "z": 0.0}
    rt, wt = float(ref_lanes.sum()), float(win_lanes.sum())
    if rt > 0 and wt > 0:
        eps = 1e-6
        p = np.maximum(ref_lanes / rt, eps)
        q = np.maximum(win_lanes / wt, eps)
        out["psi"] = float(np.sum((q - p) * np.log(q / p)))
        out["ks"] = float(np.max(np.abs(np.cumsum(win_lanes / wt - ref_lanes / rt))))
    if n_w > 0 and n_r > 0:
        var_w = max(float(mom_w[2]) / n_w, 0.0)
        var_r = max(float(mom_r[2]) / n_r, 0.0)
        denom = math.sqrt(var_w / n_w + var_r / n_r)
        if denom > 0:
            out["z"] = (float(mom_w[1]) - float(mom_r[1])) / denom
        elif float(mom_w[1]) != float(mom_r[1]):
            out["z"] = math.inf if mom_w[1] > mom_r[1] else -math.inf
    return out
