# tev: scope=host — the watchdog is a host-side daemon thread by design:
# wall-clock reads and blocking waits here never run on the update path.
"""Stall watchdog: dump hang forensics BEFORE the process dies.

Counterpart of ``torcheval_tpu/obs/watchdog.py``. A deadlocked collective
leaves a job burning money and an operator with nothing but ``kill -9``.
The deadline machinery in ``resilience.py`` bounds syncs that go THROUGH a
``ResilientGroup``; this watchdog covers everything else — plain groups
without deadlines, a deadline long enough that a human notices first, or
a hang outside the sync path entirely (per-op timeouts plus an
independent liveness monitor).

:class:`StallWatchdog` is a daemon thread polling the collective flight
recorder (``obs/flight.py``): when any in-flight record ages past the
deadline with no flight progress anywhere in the process, it **trips**:

- dumps every thread's flight ring and every thread's innermost span
  path (``obs/trace.py``) to its sink (stderr by default) and, when
  given a path, appends a JSONL forensics line — synchronously, so the
  record survives a subsequent SIGKILL;
- records a typed :class:`~torcheval_tpu_torch.obs.events.StallEvent` (ring +
  JSONL via the event recorder, when that is enabled);
- exposes ``tripped``/``trips``/``last_trip`` for ``/healthz``
  (``obs/server.py``).

One trip per stall: after tripping, the watchdog re-arms only once
flight progress resumes — a wedged pod logs one forensics block, not one
per poll tick.

Arm via ``config.observability(watchdog=<seconds>)`` (disarmed at scope
exit), :func:`arm_watchdog`, or env ``TORCHEVAL_TPU_WATCHDOG=<seconds>``
(armed at import, for jobs that cannot change code). Arming enables the
flight recorder (its own enable source — turning the event recorder off
does not blind an armed watchdog).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Any, Dict, Optional

from torcheval_tpu_torch.obs import flight as _flight
from torcheval_tpu_torch.obs import trace as _trace

__all__ = [
    "StallWatchdog",
    "arm_watchdog",
    "current_watchdog",
    "disarm_watchdog",
]


class StallWatchdog:
    """Daemon thread detecting no-flight-progress past ``deadline``.

    Args:
        deadline: seconds an in-flight collective may age (since its
            last state transition) before the watchdog trips.
        poll: poll interval (default ``min(deadline / 4, 1.0)``, floored
            at 10 ms — a test-scale deadline gets a test-scale poll).
        sink: writable text stream for the forensics dump (default
            ``sys.stderr``; pass ``None`` to suppress the stream dump).
        jsonl: optional path — each trip appends one JSON forensics line
            (the ``StallEvent`` dict plus the full flight snapshot),
            written and flushed synchronously before the method returns.
    """

    def __init__(
        self,
        deadline: float,
        *,
        poll: Optional[float] = None,
        sink: Any = "stderr",
        jsonl: Optional[str] = None,
    ) -> None:
        deadline = float(deadline)
        if not deadline > 0:
            raise ValueError(
                f"watchdog deadline must be > 0 seconds, got {deadline}"
            )
        self.deadline = deadline
        self.poll = max(
            0.01, float(poll) if poll is not None else min(deadline / 4, 1.0)
        )
        self._sink = sink
        self.jsonl = jsonl
        self.armed = False
        self.trips = 0
        self.tripped = False  # a stall is CURRENTLY being reported
        self.last_trip: Optional[Dict[str, Any]] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._progress_at_trip = -1

    # ------------------------------------------------------------ lifecycle

    def arm(self) -> "StallWatchdog":
        """Enable flight recording and start the poll thread
        (idempotent)."""
        if self.armed:
            return self
        _flight.FLIGHT.enable("watchdog")
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="torcheval-watchdog"
        )
        self.armed = True
        self._thread.start()
        return self

    def disarm(self) -> None:
        """Stop the poll thread and release the flight-recorder enable
        source (the event recorder's source, if on, keeps it on)."""
        if not self.armed:
            return
        self.armed = False
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=max(self.poll * 4, 2.0))
        _flight.FLIGHT.disable("watchdog")

    def counters(self) -> Dict[str, Any]:
        """Pull-based counter-source payload (registered as the
        ``watchdog`` source while armed)."""
        return {
            "armed": int(self.armed),
            "deadline_seconds": self.deadline,
            "trips": self.trips,
            "tripped": int(self.tripped),
        }

    def status(self) -> Dict[str, Any]:
        """The ``/healthz`` component: armed/tripped plus the last trip's
        forensics summary."""
        out = self.counters()
        out["last_trip"] = self.last_trip
        return out

    # ----------------------------------------------------------------- loop

    def _loop(self) -> None:  # tev: scope=watchdog
        fl = _flight.FLIGHT
        while not self._stop.wait(self.poll):
            progress = fl.progress
            now = time.monotonic()
            stuck = [
                r
                for r in fl.in_flight()
                # tracked exchange records (inter-region federation
                # links) are DESIGNED to stay in flight across the whole
                # inter-exchange interval — on a healthy WAN cadence far
                # longer than any collective deadline. Their health
                # authority is the federation's staleness bound
                # (/healthz "stale-region"), not the collective watchdog.
                if not getattr(r, "tracked", False)
                and r.age(now) >= self.deadline
            ]
            if not stuck:
                if self.tripped and progress != self._progress_at_trip:
                    self.tripped = False  # stall cleared: re-arm
                continue
            if self.tripped and progress == self._progress_at_trip:
                continue  # same stall, already reported
            self._progress_at_trip = progress
            self.tripped = True
            self.trips += 1
            stuck.sort(key=lambda r: r.m_last)
            self.trip(stuck[0], now)

    def trip(self, record: "_flight.FlightRecord", now: float) -> None:
        """Emit the forensics for one stalled collective (public so tests
        and the resilience layer can force a dump deterministically)."""
        from torcheval_tpu_torch.obs.events import StallEvent
        from torcheval_tpu_torch.obs.recorder import RECORDER

        snapshot = _flight.FLIGHT.snapshot()
        paths = _trace.thread_paths()
        span_path = paths.get(record.tid, "")
        age = record.age(now)
        event = StallEvent(
            rank=record.rank,
            op=record.op,
            seq=record.seq,
            age_seconds=age,
            deadline=self.deadline,
            span_path=span_path,
            detail=record.format(),
        )
        self.last_trip = {
            "op": record.op,
            "seq": record.seq,
            "rank": record.rank,
            "tid": record.tid,
            "age_seconds": age,
            "span_path": span_path,
            "t_wall": time.time(),
            # trip-TIME per-rank rings: feed straight to
            # flight.diff_flight_rings to name the stalled rank even
            # after the stall clears (the live rings move on)
            "flight": _flight.FLIGHT.per_rank(),
        }
        RECORDER.record(event)  # ring + attached JSONL, when recording
        if self._sink is not None:
            stream = sys.stderr if self._sink == "stderr" else self._sink
            try:
                stream.write(
                    f"\n*** torcheval_tpu stall watchdog: collective "
                    f"{record.op} (seq {record.seq}, rank {record.rank}) "
                    f"stuck for {age:.1f}s > deadline {self.deadline}s ***\n"
                    + (f"span path: {span_path}\n" if span_path else "")
                    + "".join(
                        f"span path [tid {tid}]: {p}\n"
                        for tid, p in sorted(paths.items())
                        if tid != record.tid
                    )
                    + _flight.format_flight(snapshot)
                )
                stream.flush()
            except Exception:  # noqa: BLE001 — forensics must not kill us
                pass
        if self.jsonl:
            # synchronous append-and-flush: the async writer discipline
            # is wrong here — the process may be SIGKILLed next
            try:
                with open(self.jsonl, "a", encoding="utf-8") as f:
                    payload = event.as_dict()
                    payload["flight"] = {
                        str(tid): ring for tid, ring in snapshot.items()
                    }
                    payload["span_paths"] = {
                        str(t): p for t, p in paths.items()
                    }
                    f.write(json.dumps(payload) + "\n")
                    f.flush()
                    os.fsync(f.fileno())
            except Exception:  # noqa: BLE001 — forensics must not kill us
                pass


_WATCHDOG: Optional[StallWatchdog] = None  # tev: guarded-by=_WATCHDOG_LOCK
_WATCHDOG_LOCK = threading.Lock()


def current_watchdog() -> Optional[StallWatchdog]:
    """The armed process-global watchdog, or ``None``."""
    wd = _WATCHDOG  # tev: disable=guarded-field -- single-reference read, atomic under the GIL; liveness probes tolerate a one-scrape-stale watchdog
    return wd if wd is not None and wd.armed else None


def arm_watchdog(
    deadline: float,
    *,
    poll: Optional[float] = None,
    sink: Any = "stderr",
    jsonl: Optional[str] = None,
) -> StallWatchdog:
    """Arm the process-global stall watchdog (replacing any armed one)
    and register its ``watchdog`` counter source. Scoped use:
    ``config.observability(watchdog=<seconds>)``."""
    from torcheval_tpu_torch.obs.counters import default_registry

    global _WATCHDOG
    with _WATCHDOG_LOCK:
        if _WATCHDOG is not None:
            _WATCHDOG.disarm()  # tev: disable=blocking-under-lock -- bounded poll-thread join (<= 4 poll intervals); the poll loop never takes _WATCHDOG_LOCK, so this is a bounded wait, not a deadlock edge
        _WATCHDOG = StallWatchdog(
            deadline, poll=poll, sink=sink, jsonl=jsonl
        )
        _WATCHDOG.arm()
        wd = _WATCHDOG
        default_registry().register("watchdog", wd.counters)
        return wd


def disarm_watchdog() -> None:
    """Disarm the process-global watchdog and unregister its counter
    source (no-op when none is armed)."""
    from torcheval_tpu_torch.obs.counters import default_registry

    global _WATCHDOG
    with _WATCHDOG_LOCK:
        if _WATCHDOG is not None:
            _WATCHDOG.disarm()  # tev: disable=blocking-under-lock -- bounded poll-thread join (<= 4 poll intervals); the poll loop never takes _WATCHDOG_LOCK, so this is a bounded wait, not a deadlock edge
            _WATCHDOG = None
            default_registry().unregister("watchdog")


def _restore_watchdog(previous: Optional[StallWatchdog]) -> None:
    """Reinstate a previously-armed watchdog INSTANCE (scope teardown:
    ``config.observability(watchdog=...)`` must hand back whatever the
    process had armed before the scope, not strip it)."""
    from torcheval_tpu_torch.obs.counters import default_registry

    global _WATCHDOG
    if previous is None:
        disarm_watchdog()
        return
    with _WATCHDOG_LOCK:
        if _WATCHDOG is not None and _WATCHDOG is not previous:
            _WATCHDOG.disarm()  # tev: disable=blocking-under-lock -- bounded poll-thread join (<= 4 poll intervals); the poll loop never takes _WATCHDOG_LOCK, so this is a bounded wait, not a deadlock edge
        _WATCHDOG = previous
        previous.arm()
        default_registry().register("watchdog", previous.counters)


# Env knob: TORCHEVAL_TPU_WATCHDOG=<seconds> arms the watchdog at import
# (same spelling family as the other config env knobs; invalid values
# warn and are ignored — an observability knob must never crash a job).
_ENV = os.environ.get("TORCHEVAL_TPU_WATCHDOG", "").strip()
if _ENV:
    try:
        _seconds = float(_ENV)
        if not _seconds > 0:
            raise ValueError
    except ValueError:
        import warnings

        warnings.warn(
            f"ignoring env TORCHEVAL_TPU_WATCHDOG={_ENV!r}: not a positive "
            "number of seconds",
            RuntimeWarning,
        )
    else:
        arm_watchdog(_seconds)
