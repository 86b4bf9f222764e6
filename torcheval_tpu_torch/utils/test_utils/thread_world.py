"""In-process emulation of an N-process group world, one thread per rank.

``LocalReplicaGroup`` models ranks as a per-replica payload LIST owned by
one caller — fine for single-controller loops, but structurally unable to
exercise rank-per-process behavior: subgroup membership, hierarchical
level routing, per-rank collective ordering. ``ThreadWorld`` closes that
gap without spawning OS processes: it hands out one ``ProcessGroup`` view
per rank, and its collectives RENDEZVOUS for real (every member blocks
until all members of the group have deposited), so group code runs the
same control flow it would across hosts.

Counterpart of ``torcheval_tpu/utils/test_utils/thread_world.py``. The
ranks are threads of one process, so on a card they share one CUDA
context and, unless a rank picks its own, the default stream; each
rank's gathers carry host numpy (``synclib`` packs on the caller).
``ThreadRankGroup.exchange_tensors`` is the device-tensor twin: it hands
tensors over by reference, with no host copy, which is how the port's
``parallel`` collectives run a ring of several ranks on one card (NCCL
refuses two ranks on one device).

::

    world = ThreadWorld(4)
    results = world.run(lambda g: sync_and_compute(metric_for(g.rank), g))

Deadline: a member waiting on peers that never arrive raises after
``timeout`` — a test bug (mismatched collective sequences) fails loudly
instead of hanging the suite.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from torcheval_tpu_torch.distributed import ProcessGroup, _as_numpy, _check_subgroup_ranks

__all__ = ["ThreadWorld", "ThreadRankGroup"]


class ThreadWorld:
    """Shared mailbox + one :class:`ThreadRankGroup` view per rank."""

    def __init__(self, world_size: int, *, timeout: float = 60.0) -> None:
        self.world_size = world_size
        self.timeout = timeout
        self._lock = threading.Condition()
        self._mail: Dict[Tuple, Dict[int, Any]] = {}  # tev: guarded-by=_lock
        self._reads: Dict[Tuple, int] = {}  # tev: guarded-by=_lock
        self._subgroup_seq: Dict[Tuple[int, ...], int] = {}  # tev: guarded-by=_lock
        self.views = [
            ThreadRankGroup(self, rank, tuple(range(world_size)))
            for rank in range(world_size)
        ]

    def subgroup_tag(self, rank: int, sub_ranks: Tuple[int, ...]) -> str:
        """Namespace one subgroup construction: per-rank views of the same
        logical subgroup must land on the same tag, while two successive
        subgroups over the same ranks must not collide. The counter is
        per (constructing rank, member set): consistent across ranks as
        long as every rank constructs its subgroups in the same order
        (the torch.distributed.new_group contract)."""
        with self._lock:
            key = (rank, sub_ranks)
            n = self._subgroup_seq.get(key, 0)
            self._subgroup_seq[key] = n + 1
        return "-".join(map(str, sub_ranks)) + f"/{n}"

    def exchange(
        self, key: Tuple, rank: int, payload: Any, ranks: Sequence[int]
    ) -> List[Any]:
        """Deposit ``payload`` under (key, rank); block until every rank in
        ``ranks`` has deposited for ``key``; return payloads in rank order."""
        members = set(ranks)
        with self._lock:
            slot = self._mail.setdefault(key, {})
            slot[rank] = payload
            self._lock.notify_all()
            ok = self._lock.wait_for(
                lambda: members.issubset(self._mail.get(key, {})),
                timeout=self.timeout,
            )
            if not ok:
                missing = sorted(members - set(self._mail.get(key, {})))
                raise TimeoutError(
                    f"collective {key} timed out waiting for ranks {missing}"
                )
            out = [self._mail[key][r] for r in sorted(members)]
            # free the slot once the last member has read it
            self._reads[key] = self._reads.get(key, 0) + 1
            if self._reads[key] == len(members):
                del self._mail[key], self._reads[key]
            return out

    def run(self, fn: Callable[["ThreadRankGroup"], Any]) -> List[Any]:
        """Call ``fn(view)`` on every rank's own thread; return results in
        rank order, re-raising the first rank's exception if any failed."""
        results: List[Any] = [None] * self.world_size
        errors: List[Optional[BaseException]] = [None] * self.world_size

        def runner(rank: int) -> None:  # tev: scope=worker
            try:
                results[rank] = fn(self.views[rank])
            except BaseException as e:  # noqa: BLE001 — ferried to caller
                errors[rank] = e

        threads = [
            threading.Thread(target=runner, args=(r,), daemon=True)
            for r in range(self.world_size)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(self.timeout + 5.0)
        for e in errors:
            if e is not None:
                raise e
        return results


class ThreadRankGroup(ProcessGroup):
    """One rank's view of a :class:`ThreadWorld` (or of a subgroup)."""

    def __init__(
        self,
        world: ThreadWorld,
        global_rank: int,
        member_ranks: Tuple[int, ...],
        *,
        tag: str = "world",
    ) -> None:
        self._world = world
        self._global_rank = global_rank
        self._member_ranks = member_ranks
        self._tag = tag
        self._seq = 0

    @property
    def world_size(self) -> int:
        return len(self._member_ranks)

    @property
    def rank(self) -> int:
        if self._global_rank not in self._member_ranks:
            return -1
        return self._member_ranks.index(self._global_rank)

    @property
    def is_member(self) -> bool:
        return self._global_rank in self._member_ranks

    @property
    def ranks(self) -> Tuple[int, ...]:
        return self._member_ranks

    def new_subgroup(self, ranks: Sequence[int]) -> "ThreadRankGroup":
        rel = _check_subgroup_ranks(ranks, len(self._member_ranks))
        sub_ranks = tuple(self._member_ranks[r] for r in rel)
        return ThreadRankGroup(
            self._world,
            self._global_rank,
            sub_ranks,
            tag=self._world.subgroup_tag(self._global_rank, sub_ranks),
        )

    def _exchange(self, payload: Any) -> List[Any]:
        if not self.is_member:
            raise RuntimeError(
                f"rank {self._global_rank} is not a member of subgroup "
                f"{self._member_ranks}"
            )
        seq = self._seq
        self._seq += 1
        return self._world.exchange(
            (self._tag, seq), self._global_rank, payload, self._member_ranks
        )

    def allgather_object(self, obj: Any) -> List[Any]:
        return self._exchange(obj)

    def allgather_array(self, x: Any) -> List[np.ndarray]:
        return [np.asarray(a) for a in self._exchange(_as_numpy(x))]

    def exchange_tensors(self, tensors: Any) -> List[Any]:
        """Gather ``tensors`` (a tensor, or a nested tuple of tensors and
        other values, ``None`` included) from every member, in rank order,
        by reference: no host copy, the readers get the depositors' own
        tensor objects, so nobody may write them in place afterwards. A
        CUDA depositor records an event on its current stream; a reader on
        another stream waits on it and marks each tensor used by its stream
        (``record_stream``), so the allocator keeps the memory alive until
        the reader's work on it is done."""
        event = stream = None
        if any(t.is_cuda for t in _tensors_in(tensors)):
            stream = torch.cuda.current_stream()
            event = torch.cuda.Event()
            event.record(stream)
        out = []
        for got, got_event, got_stream in self._exchange((tensors, event, stream)):
            if got_event is not None:
                mine = torch.cuda.current_stream()
                if got_stream != mine:
                    mine.wait_event(got_event)
                    for t in _tensors_in(got):
                        if t.is_cuda:
                            t.record_stream(mine)
            out.append(got)
        return out


def _tensors_in(payload: Any) -> List[torch.Tensor]:
    if isinstance(payload, torch.Tensor):
        return [payload]
    if isinstance(payload, tuple):
        return [t for item in payload for t in _tensors_in(item)]
    return []
