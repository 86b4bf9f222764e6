"""Replica group abstractions for metric state sync.

Counterpart of ``torcheval_tpu/distributed.py`` for this slice:
``ProcessGroup`` (the interface the sync layer needs), ``SingleProcessGroup``
(a world of one) and ``LocalReplicaGroup`` (N metric replicas driven by
one process, one per ``torch.device`` -- several may share one card). The
multi-process ``torch.distributed`` group (gloo on the CPU, NCCL on the
card) is the next slice; ``encode_length``/``decode_length``, the
int32-pair wire encoding of a payload length, are here for it.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

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
        return x.detach().cpu().numpy()
    return np.asarray(x)


class ProcessGroup:
    """Minimal interface the sync layer needs from a replica group."""

    @property
    def world_size(self) -> int:
        raise NotImplementedError

    @property
    def rank(self) -> int:
        raise NotImplementedError

    def new_subgroup(self, ranks: Sequence[int]) -> "ProcessGroup":
        raise NotImplementedError(
            f"{type(self).__name__} does not support subgroup scoping"
        )

    def allgather_array(self, x: Any) -> List[np.ndarray]:
        """Gather one same-shaped array from every rank, in rank order."""
        raise NotImplementedError

    def allgather_object(self, obj: Any) -> List[Any]:
        """Gather one picklable object from every rank, in rank order."""
        raise NotImplementedError


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


def default_process_group() -> ProcessGroup:
    """The world group: a world of one until the multi-process
    ``torch.distributed`` group lands."""
    return SingleProcessGroup()
