"""Deterministic chaos wrapper for the metric-sync collective layer.

Counterpart of ``torcheval_tpu/utils/test_utils/fault_injection.py``,
with the inter-region link chaos (``LinkFaultSpec``,
``ChaosLinkTransport``) the federation tests run under.
``FaultInjectionGroup`` decorates any
``ProcessGroup`` and injects faults into its collectives by a *scripted,
seeded* plan: no wall-clock or nondeterministic scheduling decides what
fails. It proves that every ``resilience.ResilientGroup`` degradation
policy does what it claims, and serves any test that needs a dead host, a
slow link, a flaky wire, or a corrupted payload on demand.

Fault model (every fault is keyed to a 0-based *collective call index* —
each ``allgather_object``/``allgather_array`` invocation on this wrapper,
retries included, consumes one index):

- ``drop``: rank N's payload never arrives — the call raises
  ``PartialGatherError`` carrying the ranks that DID respond, modeling a
  fault-aware collective (PCCL-style) that detects peer loss;
- ``delay``: the call sleeps ``seconds`` before returning, modeling a
  slow/hung peer (trip a ``ResilientGroup`` deadline with
  ``seconds > timeout``);
- ``transient``: the call raises ``TransientSyncError`` — a retryable
  wire glitch;
- ``corrupt``: rank N's *byte payload* is flipped at a seeded offset
  (array gathers only — object gathers are not byte-framed in-process),
  exercising the crc32 integrity check riding ``synclib``'s metadata
  exchange;
- ``duplicate``: rank N's payload is replaced with a copy of rank
  ``src``'s, modeling a misrouted/echoed message.

``dead_ranks`` is the persistent form of ``drop``: those ranks are missing
from EVERY collective — the deterministic stand-in for a host that died
mid-eval.

Beyond the collective layer, this module also drives the CRASH MATRIX of
``elastic.ElasticSession``: :class:`SnapshotCrashPlan` is a
deterministic crash-point hook for ``ElasticSession(fault_hook=...)`` —
it raises :class:`InjectedCrash` at a scripted two-phase-commit point
(``pre-shard`` / ``mid-shard`` / ``pre-manifest`` / ``post-manifest``),
modeling a preemption at exactly that instant — and the filesystem-fault
helpers (:func:`truncate_shard`, :func:`corrupt_shard`,
:func:`corrupt_manifest_digest`) tamper with a committed bundle on disk
the way a torn write or bit rot would.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Iterable, List, NamedTuple, Optional, Sequence

import numpy as np

from torcheval_tpu_torch.distributed import ProcessGroup, _as_numpy
from torcheval_tpu_torch.resilience import PartialGatherError, TransientSyncError

__all__ = [
    "ChaosLinkTransport",
    "FaultInjectionGroup",
    "FaultSpec",
    "InjectedCrash",
    "LinkFaultSpec",
    "SnapshotCrashPlan",
    "corrupt_manifest_digest",
    "corrupt_shard",
    "truncate_shard",
]

_KINDS = ("drop", "delay", "transient", "corrupt", "duplicate")


class FaultSpec(NamedTuple):
    """One scripted fault.

    Args:
        call: 0-based collective call index the fault fires at (each
            allgather on the wrapper — retries included — consumes one).
        kind: ``"drop"`` | ``"delay"`` | ``"transient"`` | ``"corrupt"`` |
            ``"duplicate"``.
        rank: the target rank for drop/corrupt/duplicate.
        times: how many consecutive calls (starting at ``call``) the fault
            covers — ``times=1`` makes it transient across a retry.
        seconds: sleep duration for ``delay``.
        src: source rank for ``duplicate`` (default: ``(rank - 1) % world``).
    """

    call: int
    kind: str
    rank: int = 0
    times: int = 1
    seconds: float = 0.05
    src: int = -1


class FaultInjectionGroup(ProcessGroup):
    """Wrap ``inner`` and apply the scripted faults to its collectives.

    Args:
        inner: the group whose collectives are sabotaged (its gathers run
            for real first; faults mutate or discard the result).
        faults: iterable of :class:`FaultSpec`.
        dead_ranks: ranks missing from every collective (persistent drop).
        seed: seeds the corrupt-offset choice; two groups with the same
            seed, faults, and call sequence behave identically.

    Examples::

        >>> from torcheval_tpu_torch.utils.test_utils import (
        ...     FaultInjectionGroup, FaultSpec,
        ... )
        >>> from torcheval_tpu_torch.resilience import ResilientGroup
        >>> # chaos = FaultInjectionGroup(group, dead_ranks={3})
        >>> # resilient = ResilientGroup(chaos, timeout=5, policy="quorum")
        >>> # sync_and_compute(metric, resilient)  # merges ranks != 3
    """

    def __init__(
        self,
        inner: ProcessGroup,
        faults: Iterable[FaultSpec] = (),
        *,
        dead_ranks: Optional[Sequence[int]] = None,
        seed: int = 0,
    ) -> None:
        self._inner = inner
        self.faults = [FaultSpec(*f) for f in faults]
        for f in self.faults:
            if f.kind not in _KINDS:
                raise ValueError(
                    f"unknown fault kind {f.kind!r}; expected one of {_KINDS}"
                )
        self.dead_ranks = frozenset(dead_ranks or ())
        self.seed = seed
        self.calls = 0  # collective calls observed (retries included)

    # --------------------------------------------------------------- plumbing

    @property
    def world_size(self) -> int:
        return self._inner.world_size

    @property
    def rank(self) -> int:
        return self._inner.rank

    def unwrap(self) -> ProcessGroup:
        return self._inner.unwrap()

    @property
    def is_member(self) -> bool:
        return self._inner.is_member

    @property
    def ranks(self):
        return self._inner.ranks

    def new_subgroup(self, ranks: Sequence[int]) -> "FaultInjectionGroup":
        """Chaos composes with subgroup scoping (so ``ResilientGroup``'s
        survivor re-formation can escalate THROUGH the chaos wrapper):
        the inner subgroup is wrapped with ``dead_ranks`` translated to
        subgroup-relative indices. Scripted call-indexed faults do NOT
        carry over — they are keyed to THIS group's call sequence, which
        the subgroup does not share."""
        from torcheval_tpu_torch.distributed import _check_subgroup_ranks

        rel = _check_subgroup_ranks(ranks, self.world_size)
        sub = self._inner.new_subgroup(rel)
        dead = tuple(
            i for i, parent_rank in enumerate(rel)
            if parent_rank in self.dead_ranks
        )
        return FaultInjectionGroup(sub, (), dead_ranks=dead, seed=self.seed)

    # ----------------------------------------------------------------- faults

    def _active(self, call: int) -> List[FaultSpec]:
        return [
            f for f in self.faults if f.call <= call < f.call + f.times
        ]

    def _apply(self, result: List[Any], is_array: bool) -> List[Any]:
        call = self.calls
        self.calls += 1
        dropped = set(self.dead_ranks)
        for f in self._active(call):
            if f.kind == "delay":
                time.sleep(f.seconds)
            elif f.kind == "transient":
                raise TransientSyncError(
                    f"injected transient wire fault at collective call {call}"
                )
            elif f.kind == "drop":
                dropped.add(f.rank)
            elif f.kind == "duplicate":
                src = f.src if f.src >= 0 else (f.rank - 1) % self.world_size
                result = list(result)
                result[f.rank] = _copy_payload(result[src])
            elif f.kind == "corrupt" and is_array:
                result = list(result)
                buf = np.ascontiguousarray(_as_numpy(result[f.rank])).copy()
                flat = buf.reshape(-1).view(np.uint8)
                if flat.size:
                    rng = np.random.default_rng(self.seed + call)
                    flat[int(rng.integers(0, flat.size))] ^= 0xFF
                result[f.rank] = buf
        if dropped:
            raise PartialGatherError(
                f"injected dead rank(s) {sorted(dropped)} at collective "
                f"call {call}",
                {
                    r: result[r]
                    for r in range(self.world_size)
                    if r not in dropped
                },
            )
        return result

    # ------------------------------------------------------------ collectives

    def allgather_object(self, obj: Any) -> List[Any]:
        return self._apply(self._inner.allgather_object(obj), is_array=False)

    def allgather_array(self, x: Any) -> List[np.ndarray]:
        return self._apply(self._inner.allgather_array(x), is_array=True)


def _copy_payload(value: Any) -> Any:
    import copy

    if isinstance(value, np.ndarray):
        return value.copy()
    return copy.deepcopy(value)


# -------------------------------------------- inter-region link chaos


class LinkFaultSpec(NamedTuple):
    """One scripted fault on a DIRECTED inter-region link.

    Keyed to the 0-based *message index* of the ``src -> dst`` link:
    each ``post`` on that directed pair — retries and probes included —
    consumes one index, so schedules replay deterministically for a
    given call sequence (the collective-call-indexed discipline of
    :class:`FaultSpec`, applied to mailbox links).

    Args:
        src / dst: region names of the directed link.
        msg: message index the fault fires at.
        kind: ``"drop"`` (never delivered), ``"delay"`` (held until the
            receiver has polled ``hold`` more times), ``"duplicate"``
            (delivered twice), ``"reorder"`` (held until the NEXT
            message on the link is posted, then delivered after it).
        times: consecutive message indices covered.
        hold: poll count for ``delay``.
    """

    src: str
    dst: str
    msg: int
    kind: str
    times: int = 1
    hold: int = 1


_LINK_KINDS = ("drop", "delay", "duplicate", "reorder")


class ChaosLinkTransport:
    """Deterministic chaos wrapper for a federation ``LinkTransport``.

    Implements the WAN failure modes the epoch ledger must be idempotent
    under: asymmetric partition between region pairs (messages dropped
    in ONE direction only), delivery delay jitter, duplicated delivery,
    and reordering — all scripted (:class:`LinkFaultSpec`) or seeded
    (``jitter_polls``), never wall-clock-scheduled, so a failed run
    replays bit-identically.

    Imperative partition control composes with the scripted faults::

        chaos = ChaosLinkTransport(InProcessLinkBus(), seed=7)
        chaos.partition("eu", "us")      # eu -> us dropped (asymmetric)
        chaos.partition_both("us", "eu") # both directions
        chaos.heal("eu", "us")           # deliveries resume

    ``jitter_polls=(lo, hi)`` holds EVERY message for a seeded number of
    receiver polls in ``[lo, hi]`` — the delay-jitter arm of a
    soak schedule. ``dropped``/``delivered`` count outcomes per directed
    link for test assertions.
    """

    def __init__(
        self,
        inner,
        faults: Iterable[LinkFaultSpec] = (),
        *,
        jitter_polls: Optional[tuple] = None,
        seed: int = 0,
    ) -> None:
        self._inner = inner
        self.faults = [LinkFaultSpec(*f) for f in faults]
        for f in self.faults:
            if f.kind not in _LINK_KINDS:
                raise ValueError(
                    f"unknown link fault kind {f.kind!r}; expected one of "
                    f"{_LINK_KINDS}"
                )
        self.jitter_polls = jitter_polls
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        self._partitioned: set = set()  # directed (src, dst) pairs
        self._sent: dict = {}  # (src, dst) -> messages posted
        self._polls: dict = {}  # dst -> polls observed
        # held messages: dst -> [(release_at_poll, order_key, blob)]
        self._held: dict = {}
        # reorder staging: (src, dst) -> blob awaiting the next post
        self._reorder: dict = {}
        self.dropped: dict = {}  # (src, dst) -> count
        self.delivered: dict = {}  # (src, dst) -> count

    # ------------------------------------------------------------ partitions

    def partition(self, src: str, dst: str) -> None:
        """Drop every ``src -> dst`` message until :meth:`heal` —
        the ASYMMETRIC partition primitive."""
        self._partitioned.add((src, dst))

    def partition_both(self, a: str, b: str) -> None:
        self.partition(a, b)
        self.partition(b, a)

    def heal(self, src: str, dst: str) -> None:
        self._partitioned.discard((src, dst))

    def heal_both(self, a: str, b: str) -> None:
        self.heal(a, b)
        self.heal(b, a)

    def partitioned(self, src: str, dst: str) -> bool:
        return (src, dst) in self._partitioned

    # ------------------------------------------------------------- transport

    def _active(self, src: str, dst: str, msg: int):
        return [
            f
            for f in self.faults
            if f.src == src and f.dst == dst and f.msg <= msg < f.msg + f.times
        ]

    def post(self, src: str, dst: str, blob: bytes) -> None:
        idx = self._sent.get((src, dst), 0)
        self._sent[(src, dst)] = idx + 1
        # a staged reorder ships AFTER this (its successor) message
        staged = self._reorder.pop((src, dst), None)
        if (src, dst) in self._partitioned:
            self.dropped[(src, dst)] = self.dropped.get((src, dst), 0) + 1
            if staged is not None:
                self._deliver(src, dst, staged)
            return
        faults = self._active(src, dst, idx)
        kinds = [f.kind for f in faults]
        if "drop" in kinds:
            self.dropped[(src, dst)] = self.dropped.get((src, dst), 0) + 1
            if staged is not None:
                self._deliver(src, dst, staged)
            return
        if "reorder" in kinds:
            # hold until the NEXT post on this link, then deliver after it
            self._reorder[(src, dst)] = bytes(blob)
            if staged is not None:
                self._deliver(src, dst, staged)
            return
        hold = 0
        for f in faults:
            if f.kind == "delay":
                hold = max(hold, int(f.hold))
        if self.jitter_polls is not None:
            lo, hi = self.jitter_polls
            hold = max(hold, int(self._rng.integers(lo, hi + 1)))
        if hold > 0:
            release = self._polls.get(dst, 0) + hold
            self._held.setdefault(dst, []).append(
                (release, len(self._held.get(dst, ())), src, bytes(blob))
            )
        else:
            self._deliver(src, dst, blob)
        if "duplicate" in kinds:
            self._deliver(src, dst, blob)
        if staged is not None:
            self._deliver(src, dst, staged)

    def _deliver(self, src: str, dst: str, blob: bytes) -> None:
        self.delivered[(src, dst)] = self.delivered.get((src, dst), 0) + 1
        self._inner.post(src, dst, blob)

    def poll(self, dst: str):
        polls = self._polls.get(dst, 0) + 1
        self._polls[dst] = polls
        held = self._held.get(dst, [])
        due = [h for h in held if h[0] <= polls]
        if due:
            self._held[dst] = [h for h in held if h[0] > polls]
            for _, _, src, blob in sorted(due, key=lambda h: (h[0], h[1])):
                self._deliver(src, dst, blob)
        return self._inner.poll(dst)

    def close(self) -> None:
        self._inner.close()


# --------------------------------------------------- elastic crash matrix


class InjectedCrash(BaseException):
    """A scripted process death (``SnapshotCrashPlan``). Derives from
    ``BaseException`` so production ``except Exception`` recovery code
    cannot accidentally swallow the simulated kill — exactly like a real
    SIGKILL, the only observable is what was left on disk."""


class SnapshotCrashPlan:
    """Deterministic crash-point hook for ``elastic.ElasticSession``.

    Raises :class:`InjectedCrash` when snapshot number ``at_snapshot``
    (0-based, counted per rank) reaches two-phase-commit point ``point``
    on ``rank`` (``None`` = every rank — a whole-pod preemption).

    >>> plan = SnapshotCrashPlan("pre-manifest", at_snapshot=1)
    >>> session = ElasticSession(metrics, d, fault_hook=plan)  # doctest: +SKIP

    ``crashed`` records whether the plan fired (so tests can assert the
    scripted death actually happened).
    """

    def __init__(
        self,
        point: str,
        *,
        at_snapshot: int = 0,
        rank: Optional[int] = None,
    ) -> None:
        from torcheval_tpu_torch.elastic import CRASH_POINTS

        if point not in CRASH_POINTS:
            raise ValueError(
                f"unknown crash point {point!r}; expected one of "
                f"{CRASH_POINTS}"
            )
        self.point = point
        self.at_snapshot = at_snapshot
        self.rank = rank
        self.crashed = False
        self._seen: dict = {}  # rank -> snapshots observed (pre-shard count)

    def __call__(self, point: str, *, generation: int, rank: int) -> None:
        if point == "pre-shard":
            self._seen[rank] = self._seen.get(rank, -1) + 1
        if self.rank is not None and rank != self.rank:
            return
        if point == self.point and self._seen.get(rank, 0) == self.at_snapshot:
            self.crashed = True
            raise InjectedCrash(
                f"injected crash at {point} of snapshot "
                f"{self.at_snapshot} (generation {generation}, rank {rank})"
            )


def _shard_path(directory: str, generation: int, rank: int) -> str:
    return os.path.join(
        directory, f"gen-{generation:08d}", f"shard-{rank:05d}.bin"
    )


def truncate_shard(
    directory: str, generation: int, rank: int = 0, keep_fraction: float = 0.5
) -> str:
    """Truncate one committed shard file in place (a torn write that the
    manifest's byte count / sha256 must catch). Returns the shard path."""
    path = _shard_path(directory, generation, rank)
    size = os.path.getsize(path)
    with open(path, "rb+") as f:
        f.truncate(max(1, int(size * keep_fraction)))
    return path


def corrupt_shard(
    directory: str, generation: int, rank: int = 0, *, seed: int = 0
) -> str:
    """Flip one byte of a committed shard at a seeded offset (bit rot that
    the manifest sha256 must catch). Returns the shard path."""
    path = _shard_path(directory, generation, rank)
    with open(path, "rb+") as f:
        blob = bytearray(f.read())
        rng = np.random.default_rng(seed + generation)
        blob[int(rng.integers(0, len(blob)))] ^= 0xFF
        f.seek(0)
        f.write(bytes(blob))
    return path


def corrupt_manifest_digest(
    directory: str, generation: int, rank: int = 0
) -> str:
    """Flip a hex digit of one shard's sha256 inside the committed
    manifest (the digest itself rotting — restore must reject the
    generation, not trust the shard). Returns the manifest path."""
    from torcheval_tpu_torch.elastic import MANIFEST_NAME

    path = os.path.join(directory, f"gen-{generation:08d}", MANIFEST_NAME)
    with open(path) as f:
        manifest = json.load(f)
    entry = next(
        e for e in manifest["shards"] if int(e["rank"]) == rank
    )
    digest = entry["sha256"]
    entry["sha256"] = ("0" if digest[0] != "0" else "1") + digest[1:]
    with open(path, "w") as f:
        json.dump(manifest, f, indent=1)
    return path
