"""SLO / anomaly monitor: streaming drift detection + budget alerting.

Counterpart of ``torcheval_tpu/obs/monitor.py``. Serving-scale online
eval is not "compute a number at the end" — it is "notice WITHIN MINUTES
that the number moved". This module closes that loop on top of the event
and latency telemetry, pull-based and off the step path:

- **Drift detection** (:meth:`Monitor.observe`): a streaming EWMA
  mean/variance per series; a sample whose z-score exceeds the
  threshold after warm-up raises a ``drift`` alert. Feed it computed
  metric values the serving loop already holds as host scalars —
  ``toolkit.sync_and_compute`` does this automatically for Python and
  numpy scalar results (never reading a tensor back from the card;
  tensor values must be fed explicitly, reading them is the caller's
  latency decision).
- **Latency drift**: each :meth:`Monitor.check` diffs the process-global
  latency digests (``obs/hist.py``) since the previous check and runs
  the new samples' p99 through the same EWMA machinery — a sync that
  quietly got 10x slower alerts without anyone instrumenting anything.
- **SLOs** (:class:`SloSpec`): declarative ``threshold`` bounds over any
  counter-registry value or latency quantile, and ``burn-rate`` specs
  over an error/total counter pair (the classic error-budget form:
  alert when the windowed error rate burns the budget ``bound`` times
  too fast).
- **Admission pressure** (the JAX package's metric tables feed their
  ingest pressure into an ``admission/pressure`` series): the tables are
  not ported yet, so no such series exists here.

Alerts are typed :class:`~torcheval_tpu_torch.obs.events.AlertEvent`\\ s — they
ride the event ring/JSONL when the recorder is on — and the active-alert
set is always available to ``/healthz`` and the Prometheus export
(``slo`` counter source: ``active_alerts``, ``alerts_total``, one
``breach_<slo>`` gauge per spec) regardless of recorder state.

Cost contract: nothing here runs on the update/sync path. ``observe``
is host float math on values the caller already holds; ``check`` runs
at scrape cadence (the health server calls it on ``/healthz``). Armed
monitor + flight recorder add no collective and no host sync to any
step.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

__all__ = [
    "EwmaStat",
    "Monitor",
    "SloSpec",
    "arm_monitor",
    "current_monitor",
    "disarm_monitor",
    "register_check_hook",
    "unregister_check_hook",
]

# Pluggable check hooks: subsystems with their own drift machinery (the
# data-quality layer, obs/quality.py) register ``fn(monitor) -> [alert
# dicts]`` here; EVERY Monitor.check runs them at its cadence (so
# ``/healthz`` probes score them with zero loop code), regardless of
# which Monitor instance runs — arming a scoped monitor must not drop
# the process's quality checks. A raising hook is isolated (one broken
# scorer must not fail the health probe), surfacing as a ``hook-error``
# entry in that check's raised list instead.
_CHECK_HOOKS: Dict[str, Any] = {}  # tev: guarded-by=_HOOK_LOCK
_HOOK_LOCK = threading.Lock()


def register_check_hook(name: str, fn) -> None:
    """Register ``fn(monitor) -> Optional[List[dict]]`` to run inside
    every :meth:`Monitor.check` (replaces an existing hook of the same
    name)."""
    with _HOOK_LOCK:
        _CHECK_HOOKS[name] = fn


def unregister_check_hook(name: str) -> None:
    """Remove a check hook (no-op when absent)."""
    with _HOOK_LOCK:
        _CHECK_HOOKS.pop(name, None)


class EwmaStat:
    """Streaming EWMA mean/variance with z-score (West 1979 incremental
    form). ``alpha`` is the smoothing factor; ``warmup`` samples must
    arrive before z-scores are reported (a cold series cannot drift)."""

    __slots__ = ("alpha", "warmup", "n", "mean", "var")

    def __init__(self, alpha: float = 0.1, warmup: int = 8) -> None:
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = float(alpha)
        self.warmup = int(warmup)
        self.n = 0
        self.mean = 0.0
        self.var = 0.0

    def update(self, x: float) -> Optional[float]:
        """Fold one sample; return its z-score against the PRE-update
        estimate (``None`` during warm-up)."""
        x = float(x)
        z: Optional[float] = None
        if self.n >= self.warmup:
            std = math.sqrt(self.var)
            if std > 0.0:
                z = (x - self.mean) / std
            elif x != self.mean:
                z = math.inf if x > self.mean else -math.inf
            else:
                z = 0.0
        if self.n == 0:
            self.mean = x
        else:
            delta = x - self.mean
            self.mean += self.alpha * delta
            self.var = (1.0 - self.alpha) * (self.var + self.alpha * delta * delta)
        self.n += 1
        return z


class SloSpec(NamedTuple):
    """One declarative service-level objective.

    ``kind="max"`` / ``"min"``: alert when the resolved ``source`` value
    crosses ``bound``. ``source`` is either a flat counter-registry key
    (``"sync.timeouts"``) or a latency quantile
    (``"latency/<op>:p99"`` — seconds, ``:p50``…``:p999`` accepted).

    ``kind="burn-rate"``: ``source`` and ``total`` name an error/total
    counter pair; over the trailing ``window`` seconds the error rate
    ``Δsource/Δtotal`` is compared against ``budget`` — alert when the
    burn rate (``rate / budget``) reaches ``bound`` (the SRE-workbook
    multi-window form collapses to one window here; compose several
    specs for multi-window burn alerts).
    """

    name: str
    source: str
    kind: str = "max"
    bound: float = 0.0
    total: str = ""
    budget: float = 0.01
    window: float = 300.0


_SLO_KINDS = ("max", "min", "burn-rate")

_QUANTILES = {"p50": 0.5, "p90": 0.9, "p95": 0.95, "p99": 0.99, "p999": 0.999}


class Monitor:
    """Streaming drift + SLO evaluation (module singleton via
    :func:`arm_monitor`; independent instances compose freely in tests).

    Args:
        slos: initial :class:`SloSpec` list (``add_slo`` appends more).
        z_threshold: |z| at which an observed series raises ``drift``.
        alpha / warmup: EWMA smoothing and warm-up sample count.
        cooldown: seconds between alerts of the same (series, kind) —
            a sustained breach alerts once per cooldown, not per scrape.
    """

    def __init__(
        self,
        *,
        slos: Tuple[SloSpec, ...] = (),
        z_threshold: float = 4.0,
        alpha: float = 0.1,
        warmup: int = 8,
        cooldown: float = 60.0,
    ) -> None:
        self.z_threshold = float(z_threshold)
        self.alpha = float(alpha)
        self.warmup = int(warmup)
        self.cooldown = float(cooldown)
        self.slos: List[SloSpec] = []  # tev: guarded-by=_lock
        self.alerts_total = 0  # tev: guarded-by=_lock
        self._lock = threading.Lock()
        self._series: Dict[str, EwmaStat] = {}  # tev: guarded-by=_lock
        self._last_alert: Dict[Tuple[str, str], float] = {}  # tev: guarded-by=_lock
        # active breaches keyed by (name, kind) -> last AlertEvent dict
        self._active: Dict[Tuple[str, str], Dict[str, Any]] = {}  # tev: guarded-by=_lock
        # burn-rate bookkeeping: per-spec deque of (t, err, tot)
        self._burn: Dict[str, List[Tuple[float, float, float]]] = {}  # tev: guarded-by=_lock
        # latency-digest bookkeeping: previous counts per key
        self._hist_prev: Dict[str, Any] = {}  # tev: guarded-by=_lock
        for spec in slos:
            self.add_slo(spec)

    # --------------------------------------------------------------- config

    def add_slo(self, spec: SloSpec) -> None:
        if spec.kind not in _SLO_KINDS:
            raise ValueError(
                f"SloSpec kind must be one of {_SLO_KINDS}, got {spec.kind!r}"
            )
        if spec.kind == "burn-rate" and not spec.total:
            raise ValueError(
                f"burn-rate SLO {spec.name!r} needs a `total` counter"
            )
        with self._lock:
            self.slos.append(spec)

    # -------------------------------------------------------------- alerts

    def _alert(
        self,
        name: str,
        kind: str,
        value: float,
        bound: float,
        message: str,
        *,
        z: float = 0.0,
        now: Optional[float] = None,
    ) -> Optional[Dict[str, Any]]:
        """Record one alert (cooldown-guarded); returns its dict or
        ``None`` when suppressed by cooldown."""
        from torcheval_tpu_torch.obs.events import AlertEvent
        from torcheval_tpu_torch.obs.recorder import RECORDER

        now = time.monotonic() if now is None else now
        key = (name, kind)
        with self._lock:
            # the alert dict is captured HERE, under the lock: re-reading
            # self._active[key] after release would return whatever a
            # concurrent checker had replaced it with
            alert = self._active[key] = {
                "name": name,
                "alert": kind,
                "value": value,
                "bound": bound,
                "z": z,
                "message": message,
                "t_mono": now,
            }
            last = self._last_alert.get(key)
            if last is not None and now - last < self.cooldown:
                return None
            self._last_alert[key] = now
            self.alerts_total += 1
        event = AlertEvent(
            name=name, alert=kind, value=float(value),
            bound=float(bound), z=float(z), message=message,
        )
        RECORDER.record(event)
        return alert

    def _clear(self, name: str, kind: str) -> None:
        with self._lock:
            self._active.pop((name, kind), None)

    def active_alerts(self) -> List[Dict[str, Any]]:
        """Currently-breaching alerts (cleared when a later check/observe
        of the same series is back in bounds)."""
        with self._lock:
            return [dict(v) for v in self._active.values()]

    # ------------------------------------------------------------- observe

    def observe(self, key: str, value: float) -> Optional[float]:
        """Feed one observed value (a computed metric the caller already
        holds as a host scalar) into series ``key``; returns the z-score
        (``None`` during warm-up). |z| past the threshold raises a
        ``drift`` alert. Thread-safe: concurrent feeders (ThreadWorld
        rank threads, the health server's per-request check threads)
        fold under the monitor lock — the EWMA read-modify-write must
        not tear."""
        value = float(value)
        with self._lock:
            stat = self._series.get(key)
            if stat is None:
                stat = self._series[key] = EwmaStat(self.alpha, self.warmup)
            z = stat.update(value)
        if z is not None and abs(z) >= self.z_threshold:
            self._alert(
                key, "drift", value, self.z_threshold,
                f"{key} drifted: value {value:.6g} is {z:+.1f} sigma from "
                f"its EWMA mean {stat.mean:.6g}",
                z=z,
            )
        elif z is not None:
            self._clear(key, "drift")
        return z

    # --------------------------------------------------------------- check

    def _resolve(self, source: str, flat: Dict[str, Any], hist) -> Optional[float]:
        """A spec source -> current value: ``latency/<op>[:pXX]`` reads
        the live digests (seconds), anything else the flat counter map."""
        if source.startswith("latency/"):
            key, _, q = source[len("latency/"):].partition(":")
            h = hist.get(key)
            if h is None:
                return None
            return h.quantile(_QUANTILES.get(q or "p99", 0.99))
        value = flat.get(source)
        return float(value) if isinstance(value, (int, float)) else None

    def _check_burn(
        self, spec: SloSpec, flat: Dict[str, Any], now: float
    ) -> Optional[Dict[str, Any]]:
        err = flat.get(spec.source)
        tot = flat.get(spec.total)
        if not isinstance(err, (int, float)) or not isinstance(
            tot, (int, float)
        ):
            return None
        with self._lock:  # concurrent checks must not tear the window
            ring = self._burn.setdefault(spec.name, [])
            ring.append((now, float(err), float(tot)))
            while ring and now - ring[0][0] > spec.window:
                ring.pop(0)
            t0, err0, tot0 = ring[0]
        d_err, d_tot = err - err0, tot - tot0
        if d_tot <= 0:
            return None
        rate = d_err / d_tot
        burn = rate / spec.budget if spec.budget > 0 else math.inf
        if burn >= spec.bound:
            return self._alert(
                spec.name, "burn-rate", burn, spec.bound,
                f"{spec.name}: error rate {rate:.4g} "
                f"({d_err:.0f}/{d_tot:.0f} over {now - t0:.0f}s) burns "
                f"budget {spec.budget:.4g} at {burn:.2f}x "
                f"(bound {spec.bound:g})",
                now=now,
            )
        self._clear(spec.name, "burn-rate")
        return None

    def check(
        self,
        *,
        registry=None,
        histograms=None,
    ) -> List[Dict[str, Any]]:
        """Evaluate every SLO against the live counters/digests AND run
        latency-drift detection over the digest deltas since the last
        check. Returns the alerts raised by THIS call (cooldown-fresh
        ones only; ``active_alerts()`` has the standing set). Pull-based:
        call it at scrape cadence (``/healthz`` does)."""
        from torcheval_tpu_torch.obs import hist as _hist
        from torcheval_tpu_torch.obs.counters import default_registry

        if registry is None:
            registry = default_registry()
        if histograms is None:
            histograms = _hist.snapshot()
        flat = registry.flat()
        now = time.monotonic()
        raised: List[Dict[str, Any]] = []

        with self._lock:
            slos = list(self.slos)
        for spec in slos:
            if spec.kind == "burn-rate":
                alert = self._check_burn(spec, flat, now)
                if alert:
                    raised.append(alert)
                continue
            value = self._resolve(spec.source, flat, histograms)
            if value is None:
                continue
            breach = value > spec.bound if spec.kind == "max" else value < spec.bound
            if breach:
                alert = self._alert(
                    spec.name, "threshold", value, spec.bound,
                    f"{spec.name}: {spec.source} = {value:.6g} violates "
                    f"{spec.kind} bound {spec.bound:g}",
                    now=now,
                )
                if alert:
                    raised.append(alert)
            else:
                self._clear(spec.name, "threshold")

        # pluggable check hooks (quality drift scoring et al.) — isolated
        # so one broken scorer cannot fail the health probe
        with _HOOK_LOCK:
            hooks = sorted(_CHECK_HOOKS.items())
        for hook_name, fn in hooks:
            try:
                raised.extend(fn(self) or [])
            except Exception as e:  # noqa: BLE001 — one hook, not the check
                raised.append(
                    {
                        "name": f"hook/{hook_name}",
                        "alert": "hook-error",
                        "message": f"{type(e).__name__}: {e}",
                    }
                )

        # latency drift: feed the p99 of the NEW samples per digest key
        for key in sorted(histograms):
            h = histograms[key]
            with self._lock:
                # atomic swap: two concurrent checks must not both
                # consume (and double-count) the same delta window
                prev = self._hist_prev.get(key)
                self._hist_prev[key] = h
            delta = _hist.LatencyHistogram()
            if prev is None:
                delta.counts = list(h.counts)
                delta.sum, delta.count = h.sum, h.count
            else:
                delta.counts = [
                    c - p for c, p in zip(h.counts, prev.counts)
                ]
                delta.sum = h.sum - prev.sum
                delta.count = h.count - prev.count
            if delta.count > 0:
                p99 = delta.quantile(0.99)
                if p99 is not None:
                    z = self.observe(f"latency/{key}:p99", p99)
                    if z is not None and abs(z) >= self.z_threshold:
                        raised.append(
                            {
                                "name": f"latency/{key}:p99",
                                "alert": "drift",
                                "value": p99,
                                "z": z,
                            }
                        )
        return raised

    # ------------------------------------------------------------ counters

    def counters(self) -> Dict[str, Any]:
        """Pull-based counter-source payload (``slo`` source): total and
        active alert counts plus one ``breach_<name>`` gauge per SLO —
        the Prometheus-facing health surface."""
        with self._lock:
            active = dict(self._active)
            slos = list(self.slos)
            total = self.alerts_total
        out: Dict[str, Any] = {
            "alerts_total": total,
            "active_alerts": len(active),
        }
        breaching = {name for name, _ in active}
        for spec in slos:
            out[f"breach_{spec.name}"] = int(spec.name in breaching)
        return out


_MONITOR: Optional[Monitor] = None  # tev: guarded-by=_MONITOR_LOCK
_MONITOR_LOCK = threading.Lock()


def current_monitor() -> Optional[Monitor]:
    """The armed process-global monitor, or ``None``."""
    return _MONITOR  # tev: disable=guarded-field -- single-reference read, atomic under the GIL; /healthz probes tolerate a stale monitor for one scrape


def arm_monitor(
    *,
    slos: Tuple[SloSpec, ...] = (),
    z_threshold: float = 4.0,
    alpha: float = 0.1,
    warmup: int = 8,
    cooldown: float = 60.0,
) -> Monitor:
    """Arm the process-global monitor (replacing any armed one) and
    register its ``slo`` counter source. Scoped use:
    ``config.observability(slos=[...])``."""
    from torcheval_tpu_torch.obs.counters import default_registry

    global _MONITOR
    with _MONITOR_LOCK:
        _MONITOR = Monitor(
            slos=tuple(slos), z_threshold=z_threshold, alpha=alpha,
            warmup=warmup, cooldown=cooldown,
        )
        default_registry().register("slo", _MONITOR.counters)
        return _MONITOR


def disarm_monitor() -> None:
    """Disarm the process-global monitor and unregister its counter
    source (no-op when none is armed)."""
    from torcheval_tpu_torch.obs.counters import default_registry

    global _MONITOR
    with _MONITOR_LOCK:
        if _MONITOR is not None:
            _MONITOR = None
            default_registry().unregister("slo")


def _restore_monitor(previous: Optional[Monitor]) -> None:
    """Reinstate a previously-armed monitor INSTANCE (scope teardown:
    ``config.observability(slos=...)`` must hand back whatever the
    process had armed before the scope, not strip it)."""
    from torcheval_tpu_torch.obs.counters import default_registry

    global _MONITOR
    if previous is None:
        disarm_monitor()
        return
    with _MONITOR_LOCK:
        _MONITOR = previous
        default_registry().register("slo", previous.counters)
