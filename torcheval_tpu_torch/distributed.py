"""Process and replica groups for metric state sync.

Counterpart of ``torcheval_tpu/distributed.py``: ``ProcessGroup`` (the
interface the sync layer needs), ``SingleProcessGroup`` (a world of one),
``LocalReplicaGroup`` (N metric replicas driven by one process, one per
``torch.device`` -- several may share one card), ``MultiHostGroup`` /
``MultiHostSubgroup``: one rank per process over ``torch.distributed``,
the counterparts of the JAX package's multi-host groups, and
``HierarchicalGroup``, the two-level gather over any of them that
supports ``new_subgroup``. Every group also speaks the participation
protocol of the resilience layer: ``unwrap()`` and the
``allgather_*_with_ranks`` gathers.

With the flight recorder on (``obs.flight``), every gather a
``MultiHostGroup`` issues leaves one record on the calling thread's ring
(one attribute read when off). A subgroup's gathers record the same op
names as the world's; the JAX package's KV-store subgroups record theirs
as ``kv_allgather``.

An object gather pickles the object, gathers every rank's byte length as
an int32 pair (``encode_length``), pads the bytes to the longest and
gathers them in one ``all_gather``. The byte tensors live where the
backend wants them: on the CPU under gloo, on ``cuda:<current device>``
under NCCL. The caller picks the backend in ``init_process_group``;
nothing here switches it.
"""

from __future__ import annotations

import pickle
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from torcheval_tpu_torch.obs import flight as _flight
from torcheval_tpu_torch.obs.flight import FLIGHT as _FLIGHT
from torcheval_tpu_torch.utils.convert import tensor_to_numpy

LENGTH_WIRE_DTYPE = np.int32
_LENGTH_BASE = 1 << 31


def encode_length(n: int) -> np.ndarray:
    """Byte length -> shape-(2,) int32 wire array (hi, lo base ``2**31``),
    valid for lengths up to ``2**62 - 1``."""
    if not 0 <= n < _LENGTH_BASE * _LENGTH_BASE:
        raise ValueError(
            f"length must be in [0, 2**62), got {n} (non-negative "
            "int32-pair wire encoding)"
        )
    return np.asarray([n // _LENGTH_BASE, n % _LENGTH_BASE], dtype=LENGTH_WIRE_DTYPE)


def decode_length(arr: Any) -> int:
    """Inverse of :func:`encode_length` for one rank's (hi, lo) pair."""
    hi, lo = (int(v) for v in np.asarray(arr).reshape(-1))
    return hi * _LENGTH_BASE + lo


def _check_subgroup_ranks(ranks: Sequence[int], world: int) -> Tuple[int, ...]:
    out = tuple(sorted(int(r) for r in ranks))
    if not out:
        raise ValueError("a subgroup needs at least one rank")
    if len(set(out)) != len(out):
        raise ValueError(f"duplicate ranks in subgroup: {list(ranks)}")
    if out[0] < 0 or out[-1] >= world:
        raise ValueError(
            f"subgroup ranks {list(ranks)} out of range for world size {world}"
        )
    return out


def _as_numpy(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return tensor_to_numpy(x)
    return np.asarray(x)


class ProcessGroup:
    """Minimal interface the sync layer needs from a replica group."""

    @property
    def world_size(self) -> int:
        raise NotImplementedError

    @property
    def rank(self) -> int:
        raise NotImplementedError

    @property
    def is_member(self) -> bool:
        """Whether this process takes part in the group's collectives; a
        subgroup handle held by a non-member says False, and the toolkit
        then returns its metrics untouched."""
        return True

    @property
    def ranks(self) -> Tuple[int, ...]:
        """Global ranks of the members, ascending."""
        return tuple(range(self.world_size))

    def new_subgroup(self, ranks: Sequence[int]) -> "ProcessGroup":
        """A group scoped to ``ranks`` (ranks of this group)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support subgroup scoping"
        )

    def allgather_array(self, x: Any) -> List[np.ndarray]:
        """Gather one same-shaped array from every rank, in rank order."""
        raise NotImplementedError

    def allgather_object(self, obj: Any) -> List[Any]:
        """Gather one picklable object from every rank, in rank order."""
        raise NotImplementedError

    # ------------------------------------------------- resilience extensions

    def unwrap(self) -> "ProcessGroup":
        """The innermost group behind any decorators (``ResilientGroup``,
        ``FaultInjectionGroup``). Plain groups return themselves; the sync
        layer dispatches on ``unwrap()`` so wrapping never changes which
        protocol (local replicas or processes) is spoken."""
        return self

    def allgather_object_with_ranks(self, obj: Any) -> Tuple[List[Any], List[int]]:
        """Gather plus the participating-rank list. Plain groups always
        return every rank; ``resilience.ResilientGroup`` overrides this to
        report partial participation after degradation."""
        return self.allgather_object(obj), list(range(self.world_size))

    def allgather_array_with_ranks(self, x: Any) -> Tuple[List[np.ndarray], List[int]]:
        """Array-gather twin of :meth:`allgather_object_with_ranks`."""
        return self.allgather_array(x), list(range(self.world_size))


class SingleProcessGroup(ProcessGroup):
    """World of one."""

    @property
    def world_size(self) -> int:
        return 1

    @property
    def rank(self) -> int:
        return 0

    def allgather_array(self, x) -> List[np.ndarray]:
        return [_as_numpy(x)]

    def allgather_object(self, obj) -> List[Any]:
        return [obj]

    def new_subgroup(self, ranks: Sequence[int]) -> "SingleProcessGroup":
        _check_subgroup_ranks(ranks, 1)
        return self


class LocalReplicaGroup(ProcessGroup):
    """N metric replicas driven by one process, one per device in
    ``devices`` (``torch.device``s; repeats are allowed, so several
    replicas may share one card). The "gathers" are in-process list
    operations: the sync entry points take the per-replica list.

    ``new_subgroup(ranks)`` scopes the group to a replica subset; the
    toolkit then accepts the member-only list or the full parent list.
    """

    def __init__(self, devices: Optional[Sequence[Any]] = None) -> None:
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "LocalReplicaGroup() defaults to one replica per CUDA "
                    "device, but no CUDA device is available; pass devices="
                    '[torch.device("cpu")] * world to run on the CPU.'
                )
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        self.devices = [torch.device(d) for d in devices]
        self._member_ranks: Optional[Tuple[int, ...]] = None
        self.parent_world: Optional[int] = None

    @property
    def world_size(self) -> int:
        return len(self.devices)

    @property
    def rank(self) -> int:
        return 0

    @property
    def ranks(self) -> Tuple[int, ...]:
        if self._member_ranks is not None:
            return self._member_ranks
        return tuple(range(self.world_size))

    def new_subgroup(self, ranks: Sequence[int]) -> "LocalReplicaGroup":
        ranks = _check_subgroup_ranks(ranks, self.world_size)
        sub = LocalReplicaGroup([self.devices[r] for r in ranks])
        sub._member_ranks = ranks
        sub.parent_world = self.world_size
        return sub

    def allgather_array(self, xs) -> List[np.ndarray]:
        return [_as_numpy(x) for x in xs]

    def allgather_object(self, objs) -> List[Any]:
        return list(objs)


class MultiHostGroup(ProcessGroup):
    """The processes of a ``torch.distributed`` job, one rank each.

    ``group`` is a ``torch.distributed`` process group (default: the
    world) and ``ranks`` its global ranks, read from ``group`` when not
    given (a process outside ``group`` must give them).
    ``torch.distributed.init_process_group`` must have run; give it the
    address (``tcp://localhost:<port>`` or a ``FileStore``), world size
    and rank yourself.
    """

    def __init__(self, group=None, ranks: Optional[Sequence[int]] = None) -> None:
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                f"{type(self).__name__} needs torch.distributed initialized "
                "(torch.distributed.init_process_group with its address, "
                "world size and rank)"
            )
        if ranks is None:
            ranks = (
                range(dist.get_world_size())
                if group is None
                else dist.get_process_group_ranks(group)
            )
        self._group = group
        self._ranks = tuple(ranks)
        me = dist.get_rank()
        self._index = self._ranks.index(me) if me in self._ranks else None

    @property
    def world_size(self) -> int:
        return len(self._ranks)

    @property
    def rank(self) -> int:
        """This process's rank in the group (-1 for a non-member)."""
        return -1 if self._index is None else self._index

    @property
    def is_member(self) -> bool:
        return self._index is not None

    @property
    def ranks(self) -> Tuple[int, ...]:
        return self._ranks

    def new_subgroup(self, ranks: Sequence[int]) -> "MultiHostSubgroup":
        """A subgroup of ``ranks`` (ranks of this group). Like
        ``torch.distributed.new_group``, which it calls, every process of
        the job calls it, in the same order; non-members get a handle with
        ``is_member == False``."""
        rel = _check_subgroup_ranks(ranks, self.world_size)
        members = [self._ranks[r] for r in rel]
        return MultiHostSubgroup(dist.new_group(ranks=members), members)

    def _byte_device(self) -> torch.device:
        if dist.get_backend(self._group) == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    def _all_gather(self, arr: np.ndarray) -> List[np.ndarray]:
        """One ``all_gather`` of a same-shaped array from every member."""
        if self._index is None:
            raise RuntimeError(
                f"process {dist.get_rank()} is not a member of the group of "
                f"ranks {self._ranks}; non-members must not issue its "
                "collectives (the toolkit returns their metrics untouched)"
            )
        local = torch.from_numpy(np.ascontiguousarray(arr)).to(self._byte_device())
        out = [torch.empty_like(local) for _ in self._ranks]
        dist.all_gather(out, local, group=self._group)
        return [t.cpu().numpy() for t in out]

    def allgather_array(self, x) -> List[np.ndarray]:
        arr = _as_numpy(x)
        if _FLIGHT.enabled:
            return _flight.guarded_collective(
                "allgather_array", arr.nbytes, self.rank, self.world_size,
                lambda: self._all_gather(arr),
            )
        return self._all_gather(arr)

    def allgather_object(self, obj) -> List[Any]:
        payload = np.frombuffer(pickle.dumps(obj), dtype=np.uint8)
        if _FLIGHT.enabled:
            return _flight.guarded_collective(
                "allgather_object", payload.nbytes, self.rank, self.world_size,
                lambda: self._allgather_object(payload),
            )
        return self._allgather_object(payload)

    def _allgather_object(self, payload: np.ndarray) -> List[Any]:
        sizes = [decode_length(n) for n in self._all_gather(encode_length(payload.size))]
        padded = np.zeros(max(sizes), dtype=np.uint8)
        padded[: payload.size] = payload
        gathered = self._all_gather(padded)
        return [pickle.loads(g[:size].tobytes()) for g, size in zip(gathered, sizes)]


class MultiHostSubgroup(MultiHostGroup):
    """A subset of the job's processes over its own ``torch.distributed``
    group, as ``MultiHostGroup.new_subgroup`` makes it; ``ranks`` are
    global ranks, and a process outside them holds a handle with
    ``is_member == False``."""

    def __init__(self, group, ranks: Sequence[int]) -> None:
        super().__init__(group, ranks)


class HierarchicalGroup(ProcessGroup):
    """Two-level eager sync: gather within each node, one exchange among
    the node leaders, then each leader broadcasts to its node.

    Counterpart of the JAX package's ``HierarchicalGroup``. Where links
    within a node (NVLink, shared memory) are much faster than those
    between nodes, a flat world-size-N gather puts N payloads on the slow
    fabric; the two-level shape exchanges one aggregate per NODE among the
    leaders instead. Results are identical to the flat gather (same
    payloads, same rank order); only the wire pattern changes.
    ``node_collectives`` / ``leader_collectives`` count the split.

    Built on :meth:`ProcessGroup.new_subgroup`, so it works over any
    rank-per-process group that supports subgroup scoping
    (``MultiHostGroup``, ``ThreadRankGroup``, ``ResilientGroup``,
    ``FaultInjectionGroup``); construct it on every process, since
    ``new_subgroup`` is collective for ``MultiHostGroup``. Nodes are
    ``group_size`` consecutive ranks, or the explicit ``groups``, which
    must partition the ranks; they are ordered by leader (lowest) rank.

    What it guarantees is the exchange SHAPE (only leaders exchange across
    nodes), not a measured speedup: over one process group on one card
    the three collectives cost more than one.
    """

    def __init__(
        self,
        inner: ProcessGroup,
        *,
        group_size: Optional[int] = None,
        groups: Optional[Sequence[Sequence[int]]] = None,
    ) -> None:
        if isinstance(inner.unwrap(), LocalReplicaGroup):
            raise ValueError(
                "HierarchicalGroup needs a rank-per-process group "
                "(MultiHostGroup); a LocalReplicaGroup is one process — "
                "there is no slow fabric to optimize"
            )
        world = inner.world_size
        if groups is None:
            if group_size is None or group_size < 1:
                raise ValueError("pass group_size >= 1 or explicit groups")
            groups = [
                list(range(lo, min(lo + group_size, world)))
                for lo in range(0, world, group_size)
            ]
        nodes = [_check_subgroup_ranks(g, world) for g in groups]
        covered = sorted(r for node in nodes for r in node)
        if covered != list(range(world)):
            raise ValueError(
                f"groups {groups} must partition ranks 0..{world - 1}"
            )
        # canonical node order = ascending leader rank: the leaders'
        # subgroup gathers in THAT order, and allgather_object zips the
        # gathered per-node lists against self._nodes
        nodes.sort(key=lambda n: n[0])
        self._inner = inner
        self._nodes = nodes
        me = inner.rank
        mine = next((n for n in nodes if me in n), None)
        if not inner.is_member or mine is None:
            # a non-member gets the graceful handle every other group
            # kind returns
            self._node = None
            self._leaders = None
        else:
            self._node = inner.new_subgroup(mine)
            self._leaders = inner.new_subgroup([n[0] for n in nodes])
        self.node_collectives = 0
        self.leader_collectives = 0

    @property
    def world_size(self) -> int:
        return self._inner.world_size

    @property
    def rank(self) -> int:
        return self._inner.rank

    @property
    def is_member(self) -> bool:
        return self._node is not None

    @property
    def ranks(self) -> Tuple[int, ...]:
        return self._inner.ranks

    def unwrap(self) -> ProcessGroup:
        return self._inner.unwrap()

    def allgather_object(self, obj: Any) -> List[Any]:
        if self._node is None:
            raise RuntimeError(
                "this process is not a member of the hierarchical group's "
                "parent; non-members must not issue its collectives (the "
                "toolkit returns their local metrics untouched)"
            )
        # level 1: gather within this node
        self.node_collectives += 1
        node_vals = self._node.allgather_object(obj)
        # level 2: ONE exchange among node leaders, each carrying its
        # whole node's payloads
        flat: Optional[List[Any]] = None
        if self._leaders.is_member:
            self.leader_collectives += 1
            per_node = self._leaders.allgather_object(node_vals)
            flat = [None] * self.world_size
            for node, vals in zip(self._nodes, per_node):
                for r, v in zip(node, vals):
                    flat[r] = v
        # level 3: leaders broadcast the assembled world within their node
        # (a gather where only the leader's slot carries data)
        self.node_collectives += 1
        shared = self._node.allgather_object(flat)
        return shared[0]  # the node leader is its subgroup's rank 0

    def allgather_array(self, x: Any) -> List[np.ndarray]:
        return [
            np.asarray(a)
            for a in self.allgather_object(np.ascontiguousarray(_as_numpy(x)))
        ]


def default_process_group() -> ProcessGroup:
    """The world group: ``MultiHostGroup()`` when ``torch.distributed`` is
    initialized with more than one process, else a world of one."""
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return MultiHostGroup()
    return SingleProcessGroup()
