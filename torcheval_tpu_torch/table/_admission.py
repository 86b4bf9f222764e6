"""Deterministic admission control for the keyed metric table (counterpart
of ``torcheval_tpu/table/_admission.py``; host numpy, so the verdicts are
the JAX package's bit for bit).

Under a traffic spike the serving-eval intake has exactly three honest
options: fall over (OOM / unbounded slot growth), hot-loop the caller,
or *measure less* — and only the last one keeps the availability story
at "millions of users" scale. This module implements measuring less as
a first-class, provenance-stamped operating point instead of a crash
mode (ROADMAP item 4; the FPGA SmartNIC posture of arXiv:2204.10943 —
heavy work never belongs on the serving step — and Prime CCL's
graceful-degradation-under-unreliable-participation discipline,
arXiv:2505.14065):

- **Degradation ladder** ``full → sampled@p → priority-shed``
  (:data:`RUNG_NAMES`). Rung transitions are decided ONLY at drain time
  (:meth:`AdmissionController.commit`, called from
  ``MetricTable._pre_adopt_commit``) as a deterministic function of the
  globally MERGED table state — so every rank steps the ladder
  identically without a single extra collective. Escalation is
  immediate (one rung per drain); de-escalation requires
  ``cooldown_drains`` consecutive calm drains below ``exit_pressure``
  (hysteresis: the enter/exit band plus the cooldown is what stops rung
  flapping under a bursty spike).
- **Stateless sampling.** Per-row keep decisions are
  ``splitmix64(key_hash ^ splitmix64(epoch))`` Bernoulli trials
  (:func:`admission_keep`) — a pure function of (key, drain epoch,
  rung), bit-identical on every rank and across world sizes, with no
  RNG state to checkpoint: elastic resume carries the rung + epoch as
  ordinary table states and a restored world sheds identically.
- **Unbiasedness.** Admitted rows are Horvitz–Thompson reweighted by
  ``1/p`` through the float value lane
  (``shardspec.ht_scale`` inside the table's ingest), so every
  accumulated column remains an unbiased estimator of the full-ingest
  column; sampling is per-(key, epoch), so an ADMITTED key's ratio
  metrics (CTR, NE, calibration) are exactly the full-ingest values for
  that epoch. ``compute()`` carries
  :class:`AdmissionProvenance` and sync results extend
  ``SyncProvenance`` with ``sampled_fraction``/``admission_rung``.
- **Pressure model.** One budget (:class:`ServingBudget`) is shared
  with eviction: ``max_keys`` bounds both the admission occupancy
  signal and the drain-time evictor, ``max_outbox`` bounds the
  routing headroom, ``p99_seconds`` reads the ``obs`` latency
  histograms (``update/<Table>`` — populated whenever the flight
  recorder instruments updates). Per-rank peaks accumulate in the
  ``pressure_peak`` table state and merge by MAX, feeding the armed
  SLO monitor as the ``admission/pressure`` series.
"""

from __future__ import annotations

import threading
import weakref
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from torcheval_tpu_torch.table._hash import _splitmix64, hash_keys

__all__ = [
    "AdmissionController",
    "AdmissionProvenance",
    "RUNG_NAMES",
    "ServingBudget",
    "admission_keep",
    "armed_tables",
    "max_armed_rung",
    "shedding_status",
]

# ladder rungs, in escalation order
RUNG_FULL = 0
RUNG_SAMPLED = 1
RUNG_SHED = 2
RUNG_NAMES: Tuple[str, ...] = ("full", "sampled", "shed")

_TWO64 = float(2.0**64)


class ServingBudget(NamedTuple):
    """The ONE budget admission and eviction share.

    ``max_keys`` is the global logical occupancy bound — arming a
    controller with it installs the same bound on the table's drain-time
    evictor, so "how full am I" means the same thing to both; admission
    keeps the *inflow* bounded while eviction keeps the *stock* bounded.
    ``max_outbox`` bounds per-rank foreign-routing headroom (entries).
    ``p99_seconds`` is the ingest-latency budget, read from the ``obs``
    log₂ latency histograms at ``check_every`` cadence. Any ``None``
    component contributes no pressure."""

    max_keys: Optional[int] = None
    max_outbox: Optional[int] = None
    p99_seconds: Optional[float] = None


class AdmissionProvenance(NamedTuple):
    """Stamped on every armed ``compute()`` (``metric.admission_provenance``)
    — the "how degraded was this number" contract. ``sampled_fraction``
    is the rung's admission probability (1.0 at rung ``full``);
    ``epoch`` the drain epoch the snapshot covers; row totals are
    cumulative since construction/reset."""

    rung: int = 0
    rung_name: str = "full"
    sampled_fraction: float = 1.0
    epoch: int = 0
    admitted_rows: int = 0
    shed_rows: int = 0


def admission_keep(
    hashed: np.ndarray, epoch: int, p: float
) -> np.ndarray:
    """Stateless Bernoulli keep mask: ``splitmix64(hash ^ splitmix64
    (epoch)) < p·2⁶⁴``.

    A pure function of (key hash, drain epoch, probability): the same
    key gets the same verdict on every rank and at every world size —
    the property that keeps sharded shed decisions coherent without an
    extra collective, and per-key estimates exact for admitted keys
    (a key is in or out for the WHOLE epoch, never half-sampled).
    Re-keying by epoch rotates the shed set so no key is starved across
    epochs at rung ``sampled``.
    """
    if p >= 1.0:
        return np.ones(hashed.shape, bool)
    if p <= 0.0:
        return np.zeros(hashed.shape, bool)
    # 1-element array: numpy's uint64 SCALAR multiply warns on
    # (wrapping) overflow, the vectorized path doesn't
    salt = _splitmix64(
        np.asarray([int(epoch) & 0xFFFFFFFFFFFFFFFF], np.uint64)
    )[0]
    z = _splitmix64(hashed ^ salt)
    threshold = np.uint64(min(int(p * _TWO64), 2**64 - 1))
    return z < threshold


# armed tables, for /healthz ("shedding" rung), the "admission" counter
# source, and federation drain-cadence tightening
_ARMED_LOCK = threading.Lock()
_ARMED: "weakref.WeakSet[Any]" = weakref.WeakSet()  # tev: guarded-by=_ARMED_LOCK


def _register_armed(table: Any) -> None:
    with _ARMED_LOCK:
        _ARMED.add(table)


def _unregister_armed(table: Any) -> None:
    with _ARMED_LOCK:
        _ARMED.discard(table)


def armed_tables() -> List[Any]:
    """Live admission-armed tables (weakly held; GC'd tables vanish)."""
    with _ARMED_LOCK:
        return list(_ARMED)


def max_armed_rung() -> int:
    """Highest ladder rung any live armed table currently occupies
    (0 when nothing is armed) — the process-wide degradation level
    ``/healthz`` and ``federation.exchange_interval`` consult."""
    rung = 0
    for table in armed_tables():
        rung = max(rung, int(table.admission_rung))
    return rung


def shedding_status() -> Dict[str, Any]:
    """Process-wide admission summary for ``/healthz``: how many tables
    are armed, the worst rung, and the lowest sampled fraction."""
    tables = armed_tables()
    rung = 0
    fraction = 1.0
    for table in tables:
        r = int(table.admission_rung)
        rung = max(rung, r)
        ctrl = table._admission
        if ctrl is not None:
            fraction = min(fraction, ctrl.sampled_fraction(r))
    return {
        "armed": len(tables),
        "shedding": rung > 0,
        "rung": rung,
        "rung_name": RUNG_NAMES[rung],
        "sampled_fraction": fraction,
    }


def armed_counter_source() -> Dict[str, Any]:
    """The ``admission`` counter source (``obs.default_registry``):
    aggregated over live armed tables, pull-based, zero hot-path cost."""
    tables = armed_tables()
    out: Dict[str, Any] = {
        "armed": len(tables),
        "rung": 0,
        "sampled_fraction": 1.0,
        "admitted_rows_total": 0,
        "shed_rows_total": 0,
        "transitions_total": 0,
    }
    for table in tables:
        r = int(table.admission_rung)
        out["rung"] = max(int(out["rung"]), r)
        ctrl = table._admission
        if ctrl is not None:
            out["sampled_fraction"] = min(
                float(out["sampled_fraction"]), ctrl.sampled_fraction(r)
            )
        out["admitted_rows_total"] += int(table.admitted_rows_total)
        out["shed_rows_total"] += int(table.shed_rows_total)
        out["transitions_total"] += int(table.admission_transitions)
    return out


class AdmissionController:
    """The degradation ladder driving a table's intake (module docstring).

    Args:
        budget: the shared :class:`ServingBudget` (a plain tuple is
            accepted). At least one component must be set.
        sample_p: admission probability at rung ``sampled`` (0 < p <= 1).
        floor_p: admission probability for NON-priority keys at rung
            ``shed`` (0 <= floor_p <= sample_p; keeping it > 0 keeps
            even the worst rung an unbiased estimator over a thin trickle).
        priority_keys: keys admitted at EVERY rung with probability 1
            (and HT weight 1 — they are never reweighted). Hashed once,
            membership-tested per batch.
        priority_reservoir: when > 0, the priority set is LEARNED online
            instead of (or on top of) the static seed: at every drain
            commit a weighted reservoir (Efraimidis–Spirakis, splitmix64
            keyed on the merged drain epoch — stateless and so
            bit-identical on every rank and across world sizes) draws
            the top-``priority_reservoir`` keys by traffic from the
            merged table and REPLACES the priority hash set. The static
            ``priority_keys`` seed only governs drains before the first
            commit. 0 (default) keeps the static set forever.
        enter_pressure: pressure at or above which the ladder escalates
            one rung at the next drain.
        exit_pressure: pressure at or below which a drain counts as calm
            (must be < ``enter_pressure`` — the hysteresis band).
        cooldown_drains: consecutive calm drains required before
            de-escalating one rung.
        check_every: ingest calls between p99 histogram reads (the
            histogram probe takes a lock; occupancy/outbox ratios are
            free and read every call).

    Every rank must arm an identically-configured controller — rung
    transitions are computed independently on the merged state, and
    identical config + identical merged state is what makes them agree.
    """

    def __init__(
        self,
        budget: Any = None,
        *,
        sample_p: float = 0.1,
        floor_p: float = 0.01,
        priority_keys: Any = None,
        priority_reservoir: int = 0,
        enter_pressure: float = 0.9,
        exit_pressure: float = 0.6,
        cooldown_drains: int = 2,
        check_every: int = 16,
    ) -> None:
        if budget is None:
            budget = ServingBudget()
        elif not isinstance(budget, ServingBudget):
            budget = ServingBudget(*budget)
        if budget.max_keys is not None and int(budget.max_keys) < 1:
            raise ValueError(f"max_keys must be >= 1, got {budget.max_keys}")
        if budget.max_outbox is not None and int(budget.max_outbox) < 1:
            raise ValueError(
                f"max_outbox must be >= 1, got {budget.max_outbox}"
            )
        if not 0.0 < float(sample_p) <= 1.0:
            raise ValueError(f"sample_p must be in (0, 1], got {sample_p}")
        if not 0.0 <= float(floor_p) <= float(sample_p):
            raise ValueError(
                f"floor_p must be in [0, sample_p], got {floor_p}"
            )
        if not 0.0 < float(exit_pressure) < float(enter_pressure):
            raise ValueError(
                "need 0 < exit_pressure < enter_pressure, got "
                f"exit={exit_pressure} enter={enter_pressure}"
            )
        if int(cooldown_drains) < 1:
            raise ValueError(
                f"cooldown_drains must be >= 1, got {cooldown_drains}"
            )
        if int(priority_reservoir) < 0:
            raise ValueError(
                f"priority_reservoir must be >= 0, got {priority_reservoir}"
            )
        self.budget = budget
        self.priority_reservoir = int(priority_reservoir)
        self.sample_p = float(sample_p)
        self.floor_p = float(floor_p)
        self.enter_pressure = float(enter_pressure)
        self.exit_pressure = float(exit_pressure)
        self.cooldown_drains = int(cooldown_drains)
        self.check_every = max(1, int(check_every))
        if priority_keys is not None and len(priority_keys):
            self._priority_hashes = np.sort(hash_keys(priority_keys))
        else:
            self._priority_hashes = np.zeros((0,), np.uint64)
        # p99 probe cache (per-table cadence counter lives on the table)
        self._p99_ratio = 0.0

    # ------------------------------------------------------------ decisions

    def sampled_fraction(self, rung: int) -> float:
        """Admission probability for non-priority keys at ``rung``."""
        return (1.0, self.sample_p, self.floor_p)[int(rung)]

    def decide(
        self, hashed: np.ndarray, epoch: int, rung: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-row ``(keep, inv_weight)`` for one batch of key hashes.

        ``inv_weight`` is the Horvitz–Thompson ``1/p`` reweight for kept
        rows (1.0 for priority keys — inclusion probability 1); values at
        dropped rows are meaningless. Pure host numpy, deterministic.
        """
        p = self.sampled_fraction(rung)
        keep = admission_keep(hashed, epoch, p)
        inv = np.full(hashed.shape, 1.0 / p if p > 0.0 else 0.0, np.float32)
        if self._priority_hashes.size:
            pos = np.searchsorted(self._priority_hashes, hashed)
            pos_c = np.minimum(pos, self._priority_hashes.size - 1)
            pri = (pos < self._priority_hashes.size) & (
                self._priority_hashes[pos_c] == hashed
            )
            keep = keep | pri
            inv[pri] = 1.0
        return keep, inv

    # -------------------------------------------------------------- pressure

    def local_pressure(
        self, table: Any, *, pending_outbox: Optional[int] = None
    ) -> float:
        """This rank's instantaneous pressure in [0, ∞): the max of the
        configured budget signals, each scaled so 0 reads comfortable
        and ~1 reads at-the-limit. The occupancy signal is the
        OVERFLOW fraction ``(demanded_keys − max_keys)/max_keys`` —
        demand beyond budget, i.e. eviction churn — not the fill ratio:
        the evictor deliberately holds the stock AT ``max_keys``, so a
        full-but-quiet table must read calm, not permanently
        escalated. Outbox pressure is the fill ratio (the outbox drains
        to empty each epoch) and the p99 signal is latency over budget.
        Recorded into the table's ``pressure_peak`` state per ingest;
        peaks merge by MAX at drain."""
        b = self.budget
        pressure = 0.0
        if b.max_keys is not None:
            demanded = max(int(table.global_keys), int(table.n_keys))
            overflow = max(0, demanded - int(b.max_keys))
            pressure = max(pressure, overflow / float(b.max_keys))
        if b.max_outbox is not None:
            fill = (
                int(table.out_h) if pending_outbox is None else pending_outbox
            )
            pressure = max(pressure, fill / float(b.max_outbox))
        if b.p99_seconds is not None:
            calls = int(getattr(table, "_admission_calls", 0)) + 1
            table._admission_calls = calls
            if calls % self.check_every == 1 or self.check_every == 1:
                from torcheval_tpu_torch.obs import hist

                h = hist.snapshot().get(f"update/{type(table).__name__}")
                q = h.quantile(0.99) if h is not None else None
                self._p99_ratio = (
                    0.0 if q is None else q / float(b.p99_seconds)
                )
            pressure = max(pressure, self._p99_ratio)
        return pressure

    # ---------------------------------------------------------------- commit

    def commit(self, table: Any) -> None:
        """Drain-time ladder step on the MERGED table (called from
        ``MetricTable._pre_adopt_commit`` before the epoch advances and
        eviction runs). Every input is merged state (``pressure_peak``
        folds per-rank peaks — including the p99 signal — by MAX; the
        occupancy ratio reads the merged pre-eviction key union) or
        shared config, so every rank computes the same transition."""
        pressure = float(table.pressure_peak)
        if self.budget.max_keys is not None:
            demanded = max(int(table.global_keys), int(table.n_keys))
            overflow = max(0, demanded - int(self.budget.max_keys))
            pressure = max(pressure, overflow / float(self.budget.max_keys))
        prev = int(table.admission_rung)
        calm = int(table.admission_calm)
        rung = prev
        if pressure >= self.enter_pressure and rung < RUNG_SHED:
            rung += 1
            calm = 0
        elif pressure <= self.exit_pressure and rung > RUNG_FULL:
            calm += 1
            if calm >= self.cooldown_drains:
                rung -= 1
                calm = 0
        else:
            calm = 0
        table.admission_rung = rung
        table.admission_calm = calm
        table.pressure_peak = 0.0
        if self.priority_reservoir > 0:
            self._refresh_reservoir(table)
        if rung != prev:
            # the new rung takes effect at the post-drain epoch
            table.admission_epoch = int(table.epoch) + 1
            table.admission_transitions = (
                int(table.admission_transitions) + 1
            )
            self._record_transition(table, prev, rung, pressure)
        from torcheval_tpu_torch.obs.monitor import current_monitor

        monitor = current_monitor()
        if monitor is not None:
            monitor.observe("admission/pressure", pressure)

    def _refresh_reservoir(self, table: Any) -> None:
        """Online priority set: one weighted-reservoir draw over the
        MERGED pre-eviction key union (Efraimidis–Spirakis — each key
        scores ``log(u)/w`` for a splitmix64 uniform ``u`` keyed on the
        drain epoch; the top ``priority_reservoir`` scores win). Inputs
        are merged state + the stateless hash, so every rank — and any
        world size replaying the same traffic — draws the same set."""
        n = int(table.n_keys)
        if n == 0:
            return
        keys = np.asarray(table._keys[:n], np.uint64)
        fields = table.family.fields
        for name in ("weight", "count", "num_examples"):
            if name in fields:
                w_field = name
                break
        else:
            w_field = fields[-1]
        if table.family.window:
            # windowed commit already folded the pending columns into
            # the ring (and zeroed them) — weight by window-total traffic
            w = np.abs(
                getattr(table, f"ring_{w_field}")[:n].cpu().numpy().astype(np.float64)
            ).sum(axis=1)
        else:
            w = np.abs(
                getattr(table, f"col_{w_field}")[:n].cpu().numpy().astype(np.float64)
            )
        salt = _splitmix64(
            np.asarray(
                [int(table.epoch) & 0xFFFFFFFFFFFFFFFF], np.uint64
            )
        )[0]
        u = (_splitmix64(keys ^ salt).astype(np.float64) + 1.0) / _TWO64
        score = np.where(w > 0.0, np.log(u) / np.maximum(w, 1e-300), -np.inf)
        k = min(self.priority_reservoir, n)
        top = np.argsort(score, kind="stable")[n - k :]
        winners = keys[top]
        winners = winners[np.isfinite(score[top])]
        self._priority_hashes = np.sort(winners)

    def rescale_world(self, old_world: int, new_world: int) -> None:
        """Rescale the outbox budget to a reformed world (failover
        reform / rejoin). The outbox holds rows bound for FOREIGN
        owners — an expected ``(world-1)/world`` fraction of uniform
        traffic — so the same per-rank intake fills it in proportion
        to that fraction. Keys and p99 budgets are world-independent
        and untouched. No-op for unset budgets or degenerate worlds."""
        b = self.budget
        old_world = int(old_world)
        new_world = int(new_world)
        if (
            b.max_outbox is None
            or old_world == new_world
            or old_world <= 1
            or new_world <= 1
        ):
            return
        ratio = ((new_world - 1) / new_world) / ((old_world - 1) / old_world)
        self.budget = b._replace(
            max_outbox=max(1, int(round(int(b.max_outbox) * ratio)))
        )

    def _record_transition(
        self, table: Any, prev: int, rung: int, pressure: float
    ) -> None:
        from torcheval_tpu_torch.obs.recorder import RECORDER as _OBS

        if not _OBS.enabled:
            return
        from torcheval_tpu_torch.obs.events import AdmissionEvent

        _OBS.record(
            AdmissionEvent(
                rank=int(table.rank),
                table=type(table).__name__,
                prev_rung=prev,
                rung=rung,
                rung_name=RUNG_NAMES[rung],
                pressure=float(pressure),
                sampled_fraction=self.sampled_fraction(rung),
                epoch=int(table.epoch) + 1,
            )
        )
