# tev: scope=host — a test-only cooperative scheduler; nothing here is
# jit-reachable, and the wall-clock waits are its control mechanism.
"""Deterministic-schedule race harness (loom-style, tests only).

A copy of ``torcheval_tpu/utils/test_utils/schedule.py`` (standard
library only), kept here so this package imports nothing of the JAX one.

Static lock checks prove lock discipline; this harness executes the
residual dynamics: it
runs N thread bodies under a cooperative scheduler that grants exactly
ONE thread the right to run at a time and re-decides at every traced
line — which includes every annotated lock acquisition and every
guarded-field access in the instrumented files. The decision sequence
is drawn from a seeded RNG, so:

- **same seed ⇒ same interleaving ⇒ same outcome** — a race found at
  seed 17 is found at seed 17 forever;
- every run returns its full decision trace as a **schedule id**, and
  :meth:`DeterministicScheduler.replay` re-executes exactly that
  interleaving — a failing schedule from a seed sweep replays as a
  pinned regression test;
- a thread that enters a REAL blocking call (a lock held by a paused
  peer) is detected by a bounded grant-acknowledgement wait and parked;
  when every live thread is blocked the harness raises
  :class:`DeadlockError` carrying each thread's current stack.

Instrumentation is ``sys.settrace`` per spawned thread, filtered to the
files named via ``trace`` (a module, function, or filename) — tests
point it at the module under test plus their own body. Production code
is never touched: the harness imports nothing from the library and the
library imports nothing from it.

::

    sched = DeterministicScheduler(seed=17, trace=[mymod])
    sched.spawn(mymod.writer, shared)
    sched.spawn(mymod.reader, shared)
    result = sched.run()
    # ... assert on shared state; on failure, pin forever:
    DeterministicScheduler.replay(result.schedule_id,
                                  spawns=[(mymod.writer, (shared,)),
                                          (mymod.reader, (shared,))])
"""

from __future__ import annotations

import random
import sys
import threading
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "DeadlockError",
    "DeterministicScheduler",
    "ScheduleResult",
]


class DeadlockError(RuntimeError):
    """Every live thread is blocked outside the scheduler (a real lock
    cycle, or a wait nobody will satisfy). ``stacks`` maps thread name
    -> formatted stack at detection time; ``decisions`` is the schedule
    prefix that drove here — replay it to reproduce."""

    def __init__(
        self, message: str, stacks: Dict[str, str], decisions: List[int]
    ) -> None:
        super().__init__(message)
        self.stacks = dict(stacks)
        self.decisions = list(decisions)


class ScheduleResult:
    """One completed schedule: per-thread return values (spawn order),
    the decision trace, and the replayable ``schedule_id``."""

    def __init__(
        self, seed: Optional[int], decisions: List[int], values: List[Any]
    ) -> None:
        self.seed = seed
        self.decisions = list(decisions)
        self.values = list(values)

    @property
    def schedule_id(self) -> str:
        seed = "?" if self.seed is None else str(self.seed)
        return f"s{seed}:" + ",".join(map(str, self.decisions))

    @staticmethod
    def parse_schedule_id(schedule_id: str) -> List[int]:
        _, _, tail = schedule_id.partition(":")
        return [int(d) for d in tail.split(",") if d != ""]


class _ThreadState:
    __slots__ = (
        "index",
        "name",
        "fn",
        "args",
        "kwargs",
        "thread",
        "parked",
        "go",
        "finished",
        "value",
        "error",
        "steps",
    )

    def __init__(self, index: int, name: str, fn, args, kwargs) -> None:
        self.index = index
        self.name = name
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.thread: Optional[threading.Thread] = None
        self.parked = threading.Event()  # at a yield point, waiting
        self.go = threading.Event()  # grant: run to the next yield point
        self.finished = False
        self.value: Any = None
        self.error: Optional[BaseException] = None
        self.steps = 0


class DeterministicScheduler:
    """Seeded cooperative scheduler over spawned thread bodies.

    Args:
        seed: RNG seed choosing which parked thread runs at each step
            (ignored when ``decisions`` is given).
        decisions: an explicit decision trace (thread indices) to REPLAY
            — :attr:`ScheduleResult.decisions`, or a schedule id via
            :meth:`replay`. After the trace is exhausted the RNG
            continues (a prefix is enough to steer to the bug).
        trace: modules / functions / filenames whose lines are yield
            points. Spawned functions' own files are always included.
        block_timeout: seconds to wait for a granted thread to reach its
            next yield point before classifying it as blocked inside a
            real wait (generous vs the microseconds a line takes — the
            classification, not the timing, is what must be stable).
        deadlock_timeout: seconds with every live thread blocked before
            raising :class:`DeadlockError`.
        max_steps: hard bound on scheduling decisions (runaway guard).
    """

    def __init__(
        self,
        seed: int = 0,
        *,
        decisions: Optional[Sequence[int]] = None,
        trace: Sequence[Any] = (),
        block_timeout: float = 0.1,
        deadlock_timeout: float = 1.0,
        max_steps: int = 50000,
    ) -> None:
        self.seed = seed
        self._rng = random.Random(seed)
        self._replay: List[int] = list(decisions or [])
        self._threads: List[_ThreadState] = []
        self._files: set = set()
        for target in trace:
            self._add_trace_target(target)
        self.block_timeout = float(block_timeout)
        self.deadlock_timeout = float(deadlock_timeout)
        self.max_steps = int(max_steps)
        self.decisions: List[int] = []
        self._started = False

    # ---------------------------------------------------------- configure

    def _add_trace_target(self, target: Any) -> None:
        if isinstance(target, str):
            self._files.add(target)
            return
        code = getattr(target, "__code__", None)
        if code is not None:
            self._files.add(code.co_filename)
            return
        filename = getattr(target, "__file__", None)
        if filename is not None:
            self._files.add(filename)
            return
        raise TypeError(
            f"cannot derive a trace file from {target!r} (pass a module, "
            "a function, or a filename)"
        )

    def spawn(
        self, fn: Callable[..., Any], *args: Any, name: Optional[str] = None, **kwargs: Any
    ) -> int:
        """Register one thread body; returns its index (= the id used in
        the decision trace). Call before :meth:`run`."""
        if self._started:
            raise RuntimeError("spawn() after run() started")
        index = len(self._threads)
        state = _ThreadState(
            index, name or f"t{index}", fn, args, kwargs
        )
        self._threads.append(state)
        code = getattr(fn, "__code__", None)
        if code is not None:
            self._files.add(code.co_filename)
        return index

    # -------------------------------------------------------------- thread

    def _tracer(self, state: _ThreadState):
        files = self._files

        def global_trace(frame, event, arg):
            if event == "call" and frame.f_code.co_filename in files:
                return local_trace
            return None

        def local_trace(frame, event, arg):
            if event == "line":
                self._yield_point(state)
            return local_trace

        return global_trace

    def _yield_point(self, state: _ThreadState) -> None:
        state.parked.set()
        state.go.wait()
        state.go.clear()

    def _runner(self, state: _ThreadState) -> None:  # tev: scope=worker
        sys.settrace(self._tracer(state))
        try:
            # initial park: nothing runs until the scheduler grants it
            self._yield_point(state)
            state.value = state.fn(*state.args, **state.kwargs)
        except BaseException as e:  # noqa: BLE001 — ferried to run()
            state.error = e
        finally:
            sys.settrace(None)
            state.finished = True
            state.parked.set()  # wake the scheduler's ready scan

    # ----------------------------------------------------------------- run

    def run(self) -> ScheduleResult:
        """Execute every spawned body to completion under the schedule.
        Raises :class:`DeadlockError` when all live threads block, and
        re-raises the first thread exception (with the decision trace
        attached as ``e.schedule_decisions``) otherwise."""
        if not self._threads:
            raise RuntimeError("nothing spawned")
        self._started = True
        for state in self._threads:
            state.thread = threading.Thread(
                target=self._runner,
                args=(state,),
                daemon=True,
                name=f"schedule-{state.name}",
            )
            state.thread.start()
        steps = 0
        while True:
            live = [t for t in self._threads if not t.finished]
            if not live:
                break
            ready = [t for t in live if t.parked.is_set()]
            if not ready:
                ready = self._await_ready(live)
            steps += 1
            if steps > self.max_steps:
                raise RuntimeError(
                    f"schedule exceeded {self.max_steps} decisions — "
                    "unbounded loop under test?"
                )
            state = self._choose(ready)
            self.decisions.append(state.index)
            state.parked.clear()
            state.go.set()
            # wait for the granted thread to park again (or finish); a
            # miss means it entered a real blocking call mid-step
            state.parked.wait(self.block_timeout)
        for state in self._threads:
            if state.thread is not None:
                state.thread.join(timeout=5.0)
        for state in self._threads:
            if state.error is not None:
                state.error.schedule_decisions = list(self.decisions)
                raise state.error
        return ScheduleResult(
            self.seed, self.decisions, [t.value for t in self._threads]
        )

    def _choose(self, ready: List[_ThreadState]) -> _ThreadState:
        ready = sorted(ready, key=lambda t: t.index)
        while self._replay:
            wanted = self._replay.pop(0)
            for t in ready:
                if t.index == wanted:
                    return t
            # the replayed thread is blocked/finished right now: wait for
            # it if it is still live (deterministic replays re-block in
            # the same places), else drop the stale decision
            live = [
                t
                for t in self._threads
                if t.index == wanted and not t.finished
            ]
            if live:
                if live[0].parked.wait(self.deadlock_timeout):
                    return live[0]
            continue
        return ready[self._rng.randrange(len(ready))]

    def _await_ready(self, live: List[_ThreadState]) -> List[_ThreadState]:
        """No thread is parked: they are all inside real blocking calls.
        Give them ``deadlock_timeout`` to surface; if none does, that is
        a deadlock — report every live thread's stack."""
        deadline = self.deadlock_timeout
        step = min(self.block_timeout, 0.02)
        waited = 0.0
        while waited < deadline:
            for t in live:
                if t.parked.wait(step):
                    return [x for x in live if x.parked.is_set()]
                waited += step
        frames = sys._current_frames()
        stacks = {}
        for t in live:
            ident = t.thread.ident if t.thread is not None else None
            frame = frames.get(ident)
            stacks[t.name] = (
                "".join(traceback.format_stack(frame))
                if frame is not None
                else "<no frame>"
            )
        raise DeadlockError(
            f"deadlock: {len(live)} live thread(s) all blocked outside "
            f"the scheduler after {self.deadlock_timeout}s "
            f"(decisions so far: {','.join(map(str, self.decisions))})",
            stacks,
            self.decisions,
        )

    # -------------------------------------------------------------- replay

    @classmethod
    def replay(
        cls,
        schedule: Any,
        *,
        spawns: Sequence[Tuple[Callable[..., Any], tuple]],
        trace: Sequence[Any] = (),
        **kwargs: Any,
    ) -> ScheduleResult:
        """Re-execute a recorded schedule: ``schedule`` is a
        :class:`ScheduleResult`, a ``schedule_id`` string, or a decision
        list; ``spawns`` re-declares the thread bodies in the SAME
        order. Same decisions ⇒ same interleaving ⇒ same outcome."""
        if isinstance(schedule, ScheduleResult):
            decisions: List[int] = schedule.decisions
        elif isinstance(schedule, str):
            decisions = ScheduleResult.parse_schedule_id(schedule)
        else:
            decisions = list(schedule)
        sched = cls(decisions=decisions, trace=trace, **kwargs)
        for fn, args in spawns:
            sched.spawn(fn, *args)
        return sched.run()
