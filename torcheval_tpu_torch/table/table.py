"""Sharded keyed metric table: online per-user and per-segment eval at
serving scale (counterpart of ``torcheval_tpu/table/table.py``).

Every other metric holds ONE state per instance; millions of users need a
metric per key (user, segment, model version). :class:`MetricTable` is
that keyed collection, with per-rank cost ``keys/world``:

- **Hash partitioning.** Keys hash deterministically
  (``table._hash.hash_keys``) and ``hash % world`` names the owning rank
  (a :class:`~torcheval_tpu_torch.metrics.shardspec.ShardContext`). A
  rank's table holds SLOTS only for the keys it owns (power-of-two slot
  growth).
- **Ingest.** ``table.ingest(keys, ...)`` is one update plan a batch:
  key-to-slot resolution on the device (``torch.searchsorted`` over one
  int64 key a slot, the hash with its sign bit flipped, so the signed
  order is the unsigned order the JAX package sorts its ``(hi, lo)``
  planes by), owned rows summed into the slot columns
  (``ops.segment``), foreign rows appended as ``(key, payload)`` entries
  to an outbox by ``index_copy_`` at a device cursor (each foreign row at
  ``cursor + its foreign-prefix rank - 1``; owned and padded rows all
  write one scratch entry past the live ones, which always holds the
  sentinel). The host reserves outbox capacity exactly from the
  ownership mask. Under ``config.shape_bucketing()`` (``ingest`` turns it
  on) a masked twin pads ragged batches to power-of-two buckets; on CUDA
  each bucket is one CUDA-graph replay (``metrics/_fuse.py``), and a
  warmed table (keys admitted, outbox grown, buckets seen) captures no
  new graph: admits, drains and loads write the live state tensors in
  place while the slot capacity holds, and the capacity is a high-water
  mark (an evicting drain keeps it; ``reset()`` releases it).
- **Drains.** The outbox records per-batch boundaries, and the
  reassembling merge folds contributions per batch, per rank, in
  ascending rank order: the float addition order of the replicated merge
  of per-key standalone metrics. ``MetricTable.adopt`` /
  ``toolkit.adopt_synced`` is the drain point: the merged logical table
  commits windowed epochs, steps the admission ladder, applies TTL and
  occupancy eviction (decided on the merged state, so identically on
  every rank), and each rank re-slices to its owned keys.
- **Float order on the card.** ``ops.segment.segment_sum`` is
  ``index_add_``, which adds with atomics on CUDA. Per-key float sums on
  the card are therefore exact where the data is integer-valued or
  dyadic, or where a batch holds one row a key (the decode regime of
  ``StreamTable``), and otherwise equal the JAX package's up to float32
  reassociation within a batch. On the CPU the adds run in row order.
- **Key planes.** The states keep the JAX package's names and layout:
  ``slot_hi``/``slot_lo`` and ``out_hi``/``out_lo`` hold the two 32-bit
  halves of each 64-bit hash. torch has no uint32 arithmetic on CUDA, so
  they are int32 tensors holding the uint32 bit patterns (the same bytes);
  ``numpy_state_dict`` shows them as uint32 and ``load_numpy_state_dict``
  takes uint32, so state dicts cross-load with the JAX package both ways.
  Ownership (``hash % world``) is reduced from the halves
  (:func:`_device_owner`), never from a signed int64.
- **Integration.** The table is a :class:`Metric`: it syncs through
  ``toolkit`` (trimmed payloads), snapshots and restores through
  ``elastic.ElasticSession`` (a world-size change re-hashes keys
  bit-identically), reports ``logical_bytes`` against ``per_rank_bytes``
  through ``obs.memory_report``, and exposes occupancy, eviction and
  per-segment gauges to the ``obs`` exporters.
"""

from __future__ import annotations

import re
import threading
import weakref
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from torcheval_tpu_torch import config
from torcheval_tpu_torch.metrics.metric import MergeKind, Metric, UpdatePlan
from torcheval_tpu_torch.metrics.shardspec import ShardContext
from torcheval_tpu_torch.ops import segment
from torcheval_tpu_torch.table._admission import (
    RUNG_NAMES,
    AdmissionController,
    AdmissionProvenance,
    _register_armed,
    _unregister_armed,
)
from torcheval_tpu_torch.table._families import (
    TableFamily,
    resolve_family,
    traffic_fields,
    windowed_fields,
)
from torcheval_tpu_torch.table._hash import (
    SENTINEL,
    hash_keys,
    order_keys,
    owner_of,
    split_planes,
)
from torcheval_tpu_torch.utils.convert import cached_index

__all__ = ["MetricTable", "TableValues", "tightest_staleness_budget"]

_MIN_SLOTS = 8
_MIN_OUTBOX = 64
_SENT32 = -1  # 0xFFFFFFFF held as an int32 bit pattern
_SIGN = -(1 << 63)  # the int64 sign bit: order key <-> raw hash bits
# state names whose int32 tensors hold uint32 bit patterns: the numpy
# boundary (utils.convert.numpy_state_dict) shows them as uint32
_PLANES = ("slot_hi", "slot_lo", "out_hi", "out_lo")
_HOST_INTS = (
    "out_h", "n_keys", "epoch", "global_keys", "inserts_total",
    "evictions_total", "admission_rung", "admission_calm",
    "admission_epoch", "admitted_rows_total", "shed_rows_total",
    "admission_transitions", "_owner_rank", "_owner_world",
)

# tables that declared a per-tenant staleness budget (read by the
# federation's exchange cadence; mirrors the _admission._ARMED registry)
_BUDGETED_LOCK = threading.Lock()
_BUDGETED: "weakref.WeakSet[Any]" = weakref.WeakSet()  # tev: guarded-by=_BUDGETED_LOCK


def tightest_staleness_budget() -> int:
    """The smallest ``staleness_epochs=`` any LIVE table declared (0 when
    none did; weakly held, so collected tenants stop constraining the
    cadence)."""
    with _BUDGETED_LOCK:
        budgets = [
            int(t.staleness_epochs) for t in _BUDGETED if getattr(t, "staleness_epochs", None)
        ]
    return min(budgets, default=0)


def _pow2(n: int, floor: int) -> int:
    """Smallest power of two >= ``n`` floored at ``floor`` (the shared
    growth policy, ``_bucket.bucket_length`` with an explicit floor)."""
    from torcheval_tpu_torch.metrics._bucket import bucket_length

    return bucket_length(int(n), floor)


def _as_numpy(value: Any) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _host_keys(keys: Any) -> np.ndarray:
    return _as_numpy(keys).reshape(-1)


def _plane_bits(planes: np.ndarray) -> np.ndarray:
    """uint32 bit patterns as their int32 holders."""
    return np.asarray(planes, np.uint32).view(np.int32)


def _join_planes(hi: Any, lo: Any) -> np.ndarray:
    """Two 32-bit planes (int32 holders, or the JAX package's uint32) ->
    the uint64 hashes."""
    hi = _as_numpy(hi).astype(np.uint32).astype(np.uint64)
    lo = _as_numpy(lo).astype(np.uint32).astype(np.uint64)
    return (hi << np.uint64(32)) | lo


class TableValues(NamedTuple):
    """One ``compute()`` snapshot: per-key values over this table's live
    slots (``keys`` are the uint64 key hashes in slot order, ascending;
    ``reprs`` maps hashes back to original keys where known)."""

    keys: np.ndarray
    values: torch.Tensor
    reprs: Dict[int, Any]

    def as_dict(self) -> Dict[Any, float]:
        """``{original_key_or_hash: float(value)}`` (host readback)."""
        vals = _as_numpy(self.values)
        return {self.reprs.get(int(k), int(k)): float(v) for k, v in zip(self.keys, vals)}


# --------------------------------------------------------------- device ops


def _device_owner(hi: torch.Tensor, lo: torch.Tensor, world: int) -> torch.Tensor:
    """``hash % world`` from the two 32-bit halves (int64 holders): equal
    to the host ``_hash.owner_of`` for world <= 65536, where no product
    leaves int64."""
    shift = (1 << 32) % world
    return ((hi % world) * shift % world + lo % world) % world


def _to_bits32(v: torch.Tensor) -> torch.Tensor:
    """Values in ``[0, 2^32)`` (int64) as int32 holding their bit pattern."""
    return (v - ((v >> 31) << 32)).to(torch.int32)


# one stable transform per (row_kernel, rank, world, n_fields, cfg,
# masked): _fuse keys its CUDA graphs on the kernel object, so it must not
# be rebuilt per call (the shardspec._ROUTE_KERNEL_CACHE discipline)
_INGEST_KERNEL_CACHE: Dict[Any, Any] = {}  # tev: disable=unguarded-state -- idempotent memo keyed by immutable config: two racers build the same transform and one insert wins


def _ingest_kernel(row_kernel, rank: int, world: int, n_fields: int, cfg: Tuple, masked: bool):
    """The table-ingest transform (see the module docstring).

    ``states = (*field_columns, last_seen, out_hi, out_lo, out_val,
    out_n)``; dynamic = ``(slot_key, keys, epoch, *family_args)`` (and the
    bucketing valid vector when ``masked``). ``keys`` are the batch's
    order keys (``_hash.order_keys``); family config (``cfg``) is baked
    into the kernel. The slot key table is a read-only dynamic argument.
    """
    key = (row_kernel, rank, world, n_fields, cfg, masked)
    fn = _INGEST_KERNEL_CACHE.get(key)
    if fn is not None:
        return fn

    def transform(states, slot_key, keys, epoch, *rest):
        fam_args, valid = (rest[:-1], rest[-1]) if masked else (rest, None)
        cols = states[:n_fields]
        last_seen, out_hi, out_lo, out_val, out_n = states[n_fields:]
        payload = row_kernel(*fam_args, *cfg)
        if not isinstance(payload, tuple):
            payload = (payload,)
        cap = int(slot_key.shape[0])
        n = int(keys.shape[0])
        device = keys.device
        stacked = torch.stack(
            [torch.broadcast_to(p.to(torch.float32), (n,)) for p in payload], dim=1
        )
        row_ok = None if valid is None else torch.arange(n, device=device) < valid[0]
        raw = keys ^ _SIGN
        hi = (raw >> 32) & 0xFFFFFFFF
        lo = raw & 0xFFFFFFFF
        if world == 1:
            owned = torch.ones((n,), dtype=torch.bool, device=device) if row_ok is None else row_ok
        else:
            owned = _device_owner(hi, lo, world) == rank
            if row_ok is not None:
                owned = owned & row_ok
        if cap:
            slot = torch.clamp(torch.searchsorted(slot_key, keys), max=cap - 1)
            found = slot_key[slot] == keys
            seg = torch.where(owned & found, slot, cap)
        else:
            seg = torch.full((n,), cap, dtype=torch.int64, device=device)
        sums = segment.segment_sum(stacked, seg, cap + 1)[:cap]
        new_cols = tuple(c + sums[:, j] for j, c in enumerate(cols))
        touched = segment.segment_count(seg, cap + 1)[:cap] > 0
        new_ls = torch.where(touched, epoch, last_seen)
        if world == 1:
            return new_cols + (new_ls, out_hi, out_lo, out_val, out_n)
        # COMPACTED foreign append: each foreign row lands at cursor + its
        # foreign-prefix rank (batch row order kept: the per-batch fold
        # order contract); owned and padded rows write the sentinel to
        # the scratch entry past the live ones
        foreign = ~owned if row_ok is None else row_ok & ~owned
        prefix = torch.cumsum(foreign.to(torch.int32), 0)
        pos = torch.where(foreign, out_n + prefix - 1, out_hi.shape[0] - 1).to(torch.int64)
        out_hi.index_copy_(0, pos, torch.where(foreign, _to_bits32(hi), _SENT32))
        out_lo.index_copy_(0, pos, torch.where(foreign, _to_bits32(lo), _SENT32))
        out_val.index_copy_(0, pos, torch.where(foreign[:, None], stacked, 0.0))
        new_out_n = (out_n + prefix[-1]).to(torch.int32) if n else out_n
        return new_cols + (new_ls, out_hi, out_lo, out_val, new_out_n)

    _INGEST_KERNEL_CACHE[key] = transform
    return transform


# one stable wrapper per row kernel (the _INGEST_KERNEL_CACHE discipline)
_ADMISSION_KERNEL_CACHE: Dict[Any, Any] = {}  # tev: disable=unguarded-state -- idempotent memo keyed by the kernel object: racers build identical wrappers and one insert wins


def _admission_row_kernel(row_kernel):
    """Wrap a family row kernel with the Horvitz-Thompson reweight: the
    armed ingest passes a per-row ``inv_weight`` vector as the leading
    family argument and every payload column is scaled by it
    (``shardspec.ht_scale``), keeping admitted rows unbiased estimators of
    the full stream. Cached, so an armed table runs one stable kernel
    across rung changes."""
    fn = _ADMISSION_KERNEL_CACHE.get(row_kernel)
    if fn is not None:
        return fn
    from torcheval_tpu_torch.metrics.shardspec import ht_scale

    def wrapped(inv_weight, *fam_args):
        payload = row_kernel(*fam_args)
        if not isinstance(payload, tuple):
            payload = (payload,)
        return ht_scale(payload, inv_weight)

    _ADMISSION_KERNEL_CACHE[row_kernel] = wrapped
    return wrapped


class MetricTable(Metric[TableValues]):
    """A hash-partitioned keyed collection of per-key metric states.

    Args:
        family: ``"ctr"`` | ``"hit_rate"`` | ``"weighted_calibration"`` |
            ``"ne"`` | ``"windowed_ne"`` (or a custom
            :class:`~torcheval_tpu_torch.table.TableFamily`).
        shard: :class:`ShardContext` naming this rank's position in the
            table world (``None`` = world 1).
        ttl: drain epochs a key may stay silent before eviction (``None``
            = never).
        max_keys: global logical occupancy bound enforced at each drain
            (oldest ``last_seen`` evicted first, ties by ascending key
            hash).
        repr_limit: per-rank cap on retained original-key reprs (scrape
            labels; unmapped keys render as their hex hash).
        admission: an :class:`~torcheval_tpu_torch.table.AdmissionController`
            to arm at construction (as :meth:`arm_admission`).
        staleness_epochs: per-tenant staleness budget in drain epochs (0 =
            unbudgeted; ``None`` defers to
            ``config.tenant_staleness_epochs()``, env
            ``TORCHEVAL_TPU_TENANT_STALENESS``).
        device: where the state lives (CUDA by default).
        **family_kwargs: family knobs (``k=`` for hit_rate, ``window=`` /
            ``from_logits=`` for the NE families).

    >>> from torcheval_tpu_torch.table import MetricTable
    >>> t = MetricTable("ctr", device="cpu")
    >>> _ = t.ingest([7, 7, 9], [1.0, 0.0, 1.0])
    >>> sorted(t.compute().as_dict().items())
    [(7, 0.5), (9, 1.0)]
    """

    _bucketed_update = True
    # capability flag read by toolkit.adopt_synced / elastic / obs.memory:
    # hash-partitioned tables reshard by key ownership, not by an axis
    # slice (``_sharded_states`` stays empty)
    _hash_partitioned = True
    # the device copy of the slot order keys moves with the states
    _extra_device_attrs = ("_slot_key",)
    # int32 states holding uint32 bit patterns (utils.convert's numpy
    # boundary shows them as uint32, the JAX package's dtype)
    _numpy_uint32_states = _PLANES

    def __init__(
        self,
        family: Any = "ctr",
        *,
        shard: Optional[ShardContext] = None,
        ttl: Optional[int] = None,
        max_keys: Optional[int] = None,
        repr_limit: int = 4096,
        admission: Optional[AdmissionController] = None,
        staleness_epochs: Optional[int] = None,
        device: Any = None,
        **family_kwargs: Any,
    ) -> None:
        if shard is not None and shard.is_mesh:
            raise NotImplementedError(
                "MetricTable partitions by key hash across a rank world; "
                "mesh ShardContexts are not supported"
            )
        super().__init__(device=device, shard=shard)
        fam, attrs = resolve_family(family, **family_kwargs)
        self.family: TableFamily = fam
        for name, value in attrs.items():
            setattr(self, name, value)
        self.rank = shard.rank if shard is not None else 0
        self.world = shard.world if shard is not None else 1
        if self.world > 65536:
            raise ValueError(
                f"MetricTable ownership math supports worlds up to 65536, got {self.world}"
            )
        if ttl is not None and int(ttl) < 1:
            raise ValueError(f"ttl must be >= 1 epochs, got {ttl}")
        if max_keys is not None and int(max_keys) < 1:
            raise ValueError(f"max_keys must be >= 1, got {max_keys}")
        self.ttl = None if ttl is None else int(ttl)
        self.max_keys = None if max_keys is None else int(max_keys)
        # per-tenant staleness budget: configuration, not state
        if staleness_epochs is None:
            staleness_epochs = config.tenant_staleness_epochs()
        if int(staleness_epochs) < 0:
            raise ValueError(
                f"staleness_epochs must be >= 0 (0 disables), got {staleness_epochs}"
            )
        self.staleness_epochs = int(staleness_epochs)
        if self.staleness_epochs:
            with _BUDGETED_LOCK:
                _BUDGETED.add(self)
        # best-effort original-key reprs (scrape labels), capped per rank
        self.repr_limit = int(repr_limit)
        self._payload_width = len(fam.fields)
        # host mirrors: the sorted uint64 hashes the live slots hold, the
        # per-ingest outbox batch boundaries, the original key reprs
        self._keys: np.ndarray = np.zeros((0,), np.uint64)
        self._bounds: List[int] = []
        self._reprs: Dict[int, Any] = {}
        self._repr_hashes: np.ndarray = np.zeros((0,), np.uint64)
        self._slot_key = torch.zeros((0,), dtype=torch.int64, device=self.device)
        # device states (growable 0-size defaults; capacity is pow2)
        i32 = torch.int32
        self._add_state("slot_hi", torch.zeros((0,), dtype=i32), merge=MergeKind.CUSTOM)
        self._add_state("slot_lo", torch.zeros((0,), dtype=i32), merge=MergeKind.CUSTOM)
        for f in fam.fields:
            self._add_state(f"col_{f}", torch.zeros((0,)), merge=MergeKind.CUSTOM)
        # rings cover the family's WINDOWED fields only
        if windowed_fields(fam):
            for f in windowed_fields(fam):
                self._add_state(f"ring_{f}", torch.zeros((0, fam.window)), merge=MergeKind.CUSTOM)
            self._add_state("epochs_recorded", torch.zeros((0,), dtype=i32), merge=MergeKind.CUSTOM)
        self._add_state("last_seen", torch.zeros((0,), dtype=i32), merge=MergeKind.CUSTOM)
        self._add_state("out_hi", torch.zeros((0,), dtype=i32), merge=MergeKind.CUSTOM)
        self._add_state("out_lo", torch.zeros((0,), dtype=i32), merge=MergeKind.CUSTOM)
        self._add_state("out_val", torch.zeros((0, self._payload_width)), merge=MergeKind.CUSTOM)
        self._add_state("out_n", torch.zeros((), dtype=i32), merge=MergeKind.CUSTOM)
        self._add_state("out_h", 0, merge=MergeKind.CUSTOM)
        # host-int bookkeeping (persisted and synced)
        self._add_state("n_keys", 0, merge=MergeKind.CUSTOM)
        self._add_state("epoch", 0, merge=MergeKind.CUSTOM)
        self._add_state("global_keys", 0, merge=MergeKind.CUSTOM)
        self._add_state("inserts_total", 0, merge=MergeKind.CUSTOM)
        self._add_state("evictions_total", 0, merge=MergeKind.CUSTOM)
        # admission-ladder states (all zero while no controller is armed)
        self._add_state("admission_rung", 0, merge=MergeKind.CUSTOM)
        self._add_state("admission_calm", 0, merge=MergeKind.CUSTOM)
        self._add_state("admission_epoch", 0, merge=MergeKind.CUSTOM)
        self._add_state("admitted_rows_total", 0, merge=MergeKind.CUSTOM)
        self._add_state("shed_rows_total", 0, merge=MergeKind.CUSTOM)
        self._add_state("admission_transitions", 0, merge=MergeKind.CUSTOM)
        self._add_state("pressure_peak", 0.0, merge=MergeKind.CUSTOM)
        # carrier descriptor: >= 0 while the live slots hold one rank's
        # owned keys; -1 after a reassembling merge made the table logical
        self._add_state("_owner_rank", int(self.rank), merge=MergeKind.CUSTOM)
        self._add_state("_owner_world", int(self.world), merge=MergeKind.CUSTOM)
        self._admission: Optional[AdmissionController] = None
        if admission is not None:
            self.arm_admission(admission)

    # ------------------------------------------------------------ properties

    @property
    def occupancy(self) -> int:
        """Live keys this rank's slots hold."""
        return int(self.n_keys)

    def _is_carrier(self) -> bool:
        return int(self._owner_rank) >= 0

    # --------------------------------------------------- admission control

    @property
    def admission(self) -> Optional[AdmissionController]:
        """The armed controller (``None`` = admit everything)."""
        return self._admission

    def arm_admission(self, controller: AdmissionController) -> "MetricTable":
        """Arm overload admission control on this table's intake.

        The controller's ``budget.max_keys`` (when set) installs the shared
        occupancy bound: the drain-time evictor and the admission pressure
        signal read the same number. Every rank of a sharded table must arm
        an identically configured controller. The armed table registers on
        the process-wide admission registry (``/healthz`` shows the
        ``shedding`` rung; the ``admission`` counter source reports it)."""
        if not isinstance(controller, AdmissionController):
            raise TypeError(
                "arm_admission expects an AdmissionController, got "
                f"{type(controller).__name__}"
            )
        budget_keys = controller.budget.max_keys
        if budget_keys is not None:
            self.max_keys = (
                int(budget_keys) if self.max_keys is None else min(int(self.max_keys), int(budget_keys))
            )
        self._admission = controller
        self._admission_calls = 0
        _register_armed(self)
        return self

    def disarm_admission(self) -> "MetricTable":
        """Return the intake to admit-everything (ladder states keep their
        values for provenance; the eviction bound stays)."""
        self._admission = None
        _unregister_armed(self)
        return self

    def _per_key_states(self) -> List[str]:
        names = ["slot_hi", "slot_lo", "last_seen"]
        names += [f"col_{f}" for f in self.family.fields]
        wf = windowed_fields(self.family)
        if wf:
            names += [f"ring_{f}" for f in wf]
            names.append("epochs_recorded")
        return names

    # ------------------------------------------------------------- the slots

    def _put(self, name: str, value: torch.Tensor) -> None:
        """Install a new value of a tensor state. Under donation a value of
        the live tensor's shape and dtype is copied INTO it, so the CUDA
        graphs that write the live tensor (``metrics/_fuse.py``) stay
        valid across admits, drains and loads that keep the capacity."""
        value = value.to(self.device)
        live = getattr(self, name, None)
        if (
            self._donation_active()
            and isinstance(live, torch.Tensor)
            and live.shape == value.shape
            and live.dtype == value.dtype
            and live.device == value.device
        ):
            live.copy_(value)
        else:
            setattr(self, name, value)

    def _slot_capacity(self, n: int) -> int:
        """Slots for ``n`` live keys on a table that keeps its rows: the
        pow2 cover, but never below the live capacity. A drain that evicts
        or re-slices keeps the slot tensors (a CUDA graph writing them
        stays valid), so capacity is a high-water mark until ``reset()``."""
        return max(_pow2(n, _MIN_SLOTS), int(self.slot_hi.shape[0]))

    def _set_slots(self, keys: np.ndarray, cap: int) -> None:
        """The slot planes and the device order keys for sorted ``keys``,
        sentinel-padded to ``cap``."""
        pad = cap - int(keys.size)
        full = np.concatenate([np.asarray(keys, np.uint64), np.full(pad, SENTINEL, np.uint64)])
        hi, lo = split_planes(full)
        self._put("slot_hi", torch.from_numpy(_plane_bits(hi)))
        self._put("slot_lo", torch.from_numpy(_plane_bits(lo)))
        order = torch.from_numpy(order_keys(full).copy()).to(self.device)
        if self._slot_key.shape == order.shape and self._slot_key.device == order.device:
            self._slot_key.copy_(order)
        else:
            self._slot_key = order

    def _admit(self, new_hashes: np.ndarray, reprs: Dict[int, Any]) -> None:
        """Insert new owned keys: recompute the sorted key set, grow slot
        capacity (pow2), and permute every per-key state row to the new
        slot order (slot == rank of the key hash in sorted order, so the
        layout is deterministic for any arrival order)."""
        # two sorted runs: a stable (run-merging) sort is linear here
        merged = np.sort(np.concatenate([self._keys, np.sort(new_hashes.astype(np.uint64))]), kind="stable")
        n_new = merged.size
        cap_new = self._slot_capacity(n_new)
        # where each OLD slot's row lands in the new order
        dest = np.searchsorted(merged, self._keys)
        src = np.full((cap_new,), int(self._keys.size), np.int64)
        src[dest] = np.arange(self._keys.size, dtype=np.int64)
        src_dev = torch.from_numpy(src).to(self.device)
        for name in self._per_key_states():
            if name in ("slot_hi", "slot_lo"):
                continue
            old = getattr(self, name)
            ext = torch.cat([old, torch.zeros((1,) + tuple(old.shape[1:]), dtype=old.dtype, device=old.device)])
            self._put(name, torch.index_select(ext, 0, src_dev))
        self._set_slots(merged, cap_new)
        self._keys = merged
        self.n_keys = int(n_new)
        self.global_keys = max(int(self.global_keys), int(n_new))
        self.inserts_total = int(self.inserts_total) + int(new_hashes.size)
        self._reprs.update(reprs)

    def _ensure_outbox(self, n_foreign: int) -> None:
        """Admit ``n_foreign`` more entries (the host knows each batch's
        exact foreign count from the ownership mask) plus the scratch
        entry the ingest writes owned and padded rows to."""
        needed = int(self.out_h) + int(n_foreign) + 1
        cap = int(self.out_hi.shape[0])
        if needed <= cap:
            return
        new_cap = _pow2(needed, _MIN_OUTBOX)
        grow = new_cap - cap
        dev = self.device
        self.out_hi = torch.cat([self.out_hi, torch.full((grow,), _SENT32, dtype=torch.int32, device=dev)])
        self.out_lo = torch.cat([self.out_lo, torch.full((grow,), _SENT32, dtype=torch.int32, device=dev)])
        self.out_val = torch.cat(
            [self.out_val, torch.zeros((grow, self._payload_width), dtype=torch.float32, device=dev)]
        )

    # ---------------------------------------------------------------- ingest

    def update(self, keys: Any, *args: Any, **kwargs: Any) -> "MetricTable":
        """Accumulate one batch of keyed rows: one update plan (slot
        resolution, owned scatter, foreign outbox append). An EMPTY key
        batch is a host-side no-op (``_update_plan`` returns ``None``)."""
        plan = self._update_plan(keys, *args, **kwargs)
        if plan is None:
            return self
        return self._apply_update_plan(plan)

    def ingest(self, keys: Any, *args: Any, **kwargs: Any) -> "MetricTable":
        """The streaming front door: :meth:`update` with shape bucketing on
        (serving traffic is ragged; on CUDA every distinct length would
        otherwise run eagerly, a bucket is one CUDA-graph replay).
        :meth:`update` remains the caller-controlled path."""
        if config.shape_bucketing_enabled():
            return self.update(keys, *args, **kwargs)
        with config.shape_bucketing(True):
            return self.update(keys, *args, **kwargs)

    def _update_plan(self, keys: Any, *args: Any, **kwargs: Any):
        if not self._is_carrier():
            raise RuntimeError(
                "this MetricTable carries a merged (logical) key union — it "
                "is a sync/restore intermediate; ingest on the working "
                "per-rank table (load a logical payload to re-slice it)"
            )
        if int(self._owner_rank) != self.rank or int(self._owner_world) != self.world:
            raise RuntimeError(
                f"MetricTable holds rank {int(self._owner_rank)} of world "
                f"{int(self._owner_world)} but is configured as rank "
                f"{self.rank} of world {self.world}; foreign carriers are "
                "merge/sync intermediates and cannot be updated"
            )
        keys = _host_keys(keys)
        hashed = hash_keys(keys)
        fam_dynamic, fam_config = self.family.prepare(self, *args, **kwargs)
        n = int(hashed.size)
        # per-row arguments are row-aligned on axis 0 (0-d ones broadcast
        # inside the row kernel); the ragged-axis labels for bucketing
        fam_axes = tuple(("n",) if arg.ndim >= 1 else () for arg in fam_dynamic)
        for arg, labels in zip(fam_dynamic, fam_axes):
            if labels and int(arg.shape[0]) != n:
                raise ValueError(
                    f"table ingest: {n} keys but a per-row argument has {int(arg.shape[0])} rows"
                )
        if n == 0:
            # empty decode tail: nothing to admit, scatter or ship; the
            # argument checks above still ran
            return None
        # admission gate: a stateless splitmix64(key, epoch) Bernoulli keep
        # mask sheds rows on the HOST before any slot growth, outbox
        # reservation or device work. Kept rows carry their
        # Horvitz-Thompson 1/p reweight as a per-row argument.
        ctrl = self._admission
        inv_weight: Optional[np.ndarray] = None
        if ctrl is not None:
            keep, inv_weight = ctrl.decide(hashed, int(self.epoch), int(self.admission_rung))
            n_keep = int(keep.sum())
            self.admitted_rows_total = int(self.admitted_rows_total) + n_keep
            self.shed_rows_total = int(self.shed_rows_total) + (n - n_keep)
            if n_keep < n:
                kept = np.flatnonzero(keep)
                kept_dev = torch.from_numpy(kept).to(self.device)
                keys = keys[kept]
                hashed = hashed[kept]
                inv_weight = inv_weight[kept]
                fam_dynamic = tuple(
                    torch.index_select(arg, 0, kept_dev) if labels else arg
                    for arg, labels in zip(fam_dynamic, fam_axes)
                )
                n = n_keep
        # host intake: admit unseen OWNED keys (the device lookup needs
        # every owned key resolvable), stamp reprs, reserve outbox
        owners = owner_of(hashed, self.world)
        owned = hashed[owners == self.rank]
        if owned.size:
            pos = np.searchsorted(self._keys, owned)
            pos_c = np.minimum(pos, max(self._keys.size - 1, 0))
            known = (
                (pos < self._keys.size) & (self._keys[pos_c] == owned)
                if self._keys.size
                else np.zeros(owned.shape, bool)
            )
            fresh = np.unique(owned[~known])
            if fresh.size:
                self._admit(fresh, {})
        # best-effort reprs for every observed key (owned or foreign: the
        # owner may only see a foreign key through the outbox, so the
        # observing rank's repr travels with the sync payload)
        if len(self._reprs) >= self.repr_limit:
            uniq = np.zeros((0,), np.uint64)
        else:
            uniq = np.unique(hashed)
        pos = np.searchsorted(self._repr_hashes, uniq)
        pos_c = np.minimum(pos, max(self._repr_hashes.size - 1, 0))
        unseen = (
            uniq[~((pos < self._repr_hashes.size) & (self._repr_hashes[pos_c] == uniq))]
            if self._repr_hashes.size
            else uniq
        )
        if unseen.size:
            room = max(self.repr_limit - len(self._reprs), 0)
            self._reprs.update(self._collect_reprs(keys, hashed, unseen[:room]))
            self._repr_hashes = np.asarray(sorted(self._reprs), np.uint64)
        n_foreign = int((owners != self.rank).sum())
        if self.world > 1:
            self._ensure_outbox(n_foreign)
        if ctrl is not None:
            self.pressure_peak = max(
                float(self.pressure_peak),
                ctrl.local_pressure(self, pending_outbox=int(self.out_h) + n_foreign),
            )
        order = torch.from_numpy(order_keys(hashed).copy()).to(self.device)
        epoch = int(self.epoch)
        out_h = int(self.out_h)

        def finalize() -> None:
            if n_foreign:
                self.out_h = out_h + n_foreign
                self._bounds.append(out_h + n_foreign)

        state_names = tuple(
            [f"col_{f}" for f in self.family.fields]
            + ["last_seen", "out_hi", "out_lo", "out_val", "out_n"]
        )
        n_fields = len(self.family.fields)
        # an armed intake wraps the row kernel with the HT reweight and
        # rides inv_weight as a per-row argument: one stable kernel across
        # rung changes (an unarmed table keeps the baseline plan)
        if ctrl is not None:
            row_kernel = _admission_row_kernel(self.family.row_kernel)
            admit_dynamic: Tuple[Any, ...] = (
                torch.from_numpy(np.asarray(inv_weight, np.float32)).to(self.device),
            )
            admit_axes: Tuple[Any, ...] = (("n",),)
        else:
            row_kernel = self.family.row_kernel
            admit_dynamic = ()
            admit_axes = ()
        dynamic = (self._slot_key, order, cached_index(epoch, self.device)) + admit_dynamic + tuple(fam_dynamic)
        batch_axes = ((), ("n",), ()) + admit_axes + fam_axes
        return UpdatePlan(
            kernel=_ingest_kernel(row_kernel, self.rank, self.world, n_fields, fam_config, False),
            state_names=state_names,
            dynamic=dynamic,
            config=(),
            transform=True,
            finalize=finalize,
            masked_kernel=_ingest_kernel(row_kernel, self.rank, self.world, n_fields, fam_config, True),
            batch_axes=batch_axes,
        )

    def _collect_reprs(self, keys: np.ndarray, hashed: np.ndarray, fresh: np.ndarray) -> Dict[int, Any]:
        want = set(int(h) for h in fresh)
        out: Dict[int, Any] = {}
        for k, h in zip(np.asarray(keys).reshape(-1).tolist(), hashed.tolist()):
            if int(h) in want and int(h) not in out:
                out[int(h)] = k
        return out

    # --------------------------------------------------------------- compute

    def compute(self) -> TableValues:
        """Per-key values over this table's live slots (a carrier covers
        its OWNED keys; foreign traffic observed locally is in the outbox
        until the next drain; a merged table covers the whole key union)."""
        n = int(self.n_keys)
        wf = set(windowed_fields(self.family))
        cols = {
            f: (
                torch.sum(getattr(self, f"ring_{f}")[:n], dim=-1)
                if f in wf
                else getattr(self, f"col_{f}")[:n]
            )
            for f in self.family.fields
        }
        values = self.family.compute(cols)
        self._stamp_admission_provenance()
        return TableValues(keys=self._keys.copy(), values=values, reprs=dict(self._reprs))

    def _stamp_admission_provenance(self) -> None:
        """Every armed ``compute()`` carries ladder provenance (dropped by
        ``reset()`` and ``load_state_dict()`` like ``sync_provenance``)."""
        ctrl = self._admission
        if ctrl is None:
            return
        rung = int(self.admission_rung)
        self.admission_provenance = AdmissionProvenance(
            rung=rung,
            rung_name=RUNG_NAMES[rung],
            sampled_fraction=ctrl.sampled_fraction(rung),
            epoch=int(self.epoch),
            admitted_rows=int(self.admitted_rows_total),
            shed_rows=int(self.shed_rows_total),
        )

    # ----------------------------------------------------------------- merge

    def merge_state(self, metrics: Any) -> "MetricTable":
        """Reassemble the logical key union from per-rank carriers.

        Per key: each carrier's contribution ``S_q`` is its slot value (the
        owner) or the per-batch fold of its outbox entries (everyone
        else), and the union folds ``S_0 + S_1 + ...`` in ascending
        carried-rank order, the float addition order of the replicated
        merge of per-key standalone metrics. Afterwards ``self`` is
        DESHARDED (``_owner_rank == -1``): ``compute()`` covers every key,
        and loading its ``state_dict`` into a working table re-slices to
        that rank's owned keys."""
        from torcheval_tpu_torch.metrics.shardspec import complete_bounds

        carriers = sorted([self] + list(metrics), key=lambda c: int(c._owner_rank))
        worlds = {int(c._owner_world) for c in carriers if int(c._owner_rank) >= 0}
        if len(worlds) > 1:
            raise RuntimeError(f"cannot merge table carriers from different worlds {sorted(worlds)}")
        dev = self.device
        # the union: every carrier's live keys plus every outbox key
        outboxes = []
        parts = [c._keys[: int(c.n_keys)] for c in carriers]
        for c in carriers:
            cnt = int(c.out_h)
            hk = _join_planes(c.out_hi[:cnt], c.out_lo[:cnt]) if cnt else np.zeros((0,), np.uint64)
            outboxes.append(hk)
            parts.append(hk[hk != SENTINEL])
        union = np.unique(np.concatenate(parts)) if parts else np.zeros((0,), np.uint64)
        n_u = int(union.size)
        fields = self.family.fields
        width = len(fields)
        logical = torch.zeros((n_u, width), dtype=torch.float32, device=dev)
        win = self.family.window
        wfields = windowed_fields(self.family)
        if wfields:
            rings = {f: torch.zeros((n_u, win), dtype=torch.float32, device=dev) for f in wfields}
            epochs_rec = torch.zeros((n_u,), dtype=torch.int32, device=dev)
        last_seen = np.zeros((n_u,), np.int64)
        merged_epoch = max((int(c.epoch) for c in carriers), default=0)
        for c, hk in zip(carriers, outboxes):
            n_c = int(c.n_keys)
            pos_np = np.searchsorted(union, c._keys[:n_c])
            pos = torch.from_numpy(pos_np.astype(np.int64)).to(dev)
            delta = torch.zeros((n_u, width), dtype=torch.float32, device=dev)
            if n_c:
                own = torch.stack([getattr(c, f"col_{f}")[:n_c].to(dev) for f in fields], dim=1)
                delta.index_copy_(0, pos, own)
                np.maximum.at(last_seen, pos_np, _as_numpy(c.last_seen[:n_c]).astype(np.int64))
                if wfields:
                    for f in wfields:
                        rings[f].index_add_(0, pos, getattr(c, f"ring_{f}")[:n_c].to(dev))
                    epochs_rec.scatter_reduce_(
                        0, pos, c.epochs_recorded[:n_c].to(dev), reduce="amax", include_self=True
                    )
            cnt = int(c.out_h)
            if cnt:
                live = hk != SENTINEL
                ids = np.where(live, np.searchsorted(union, hk), n_u).astype(np.int64)
                np.maximum.at(last_seen, np.minimum(ids, max(n_u - 1, 0))[live], merged_epoch)
                vals = c.out_val[:cnt].to(dev)
                ids_dev = torch.from_numpy(ids).to(dev)
                start = 0
                for stop in complete_bounds(c._bounds, cnt):
                    if stop <= start:
                        continue
                    delta = delta + segment.segment_sum(vals[start:stop], ids_dev[start:stop], n_u + 1)[:n_u]
                    start = stop
            logical = logical + delta
        # install the union as this table's live (desharded) state
        cap = _pow2(n_u, _MIN_SLOTS)
        pad = cap - n_u
        self._set_slots(union, cap)
        for j, f in enumerate(fields):
            self._put(f"col_{f}", torch.nn.functional.pad(logical[:, j], (0, pad)))
        for f in wfields:
            self._put(f"ring_{f}", torch.nn.functional.pad(rings[f], (0, 0, 0, pad)))
        if wfields:
            self._put("epochs_recorded", torch.nn.functional.pad(epochs_rec, (0, pad)))
        self._put(
            "last_seen",
            torch.from_numpy(np.pad(last_seen.astype(np.int32), (0, pad))),
        )
        self._keys = union
        self.n_keys = n_u
        self.global_keys = n_u
        self.epoch = merged_epoch
        # MAX, not sum: after an adopt every rank carries the same
        # drain-global totals; summing would compound them world-fold
        self.inserts_total = max((int(c.inserts_total) for c in carriers), default=0)
        self.evictions_total = max((int(c.evictions_total) for c in carriers), default=0)
        # admission ladder: rung/calm/epoch are identical on every rank
        # after an adopt; row totals follow the inserts_total MAX
        # discipline; pressure_peak folds each rank's since-drain peak
        for name in (
            "admission_rung", "admission_calm", "admission_epoch",
            "admitted_rows_total", "shed_rows_total", "admission_transitions",
        ):
            setattr(self, name, max((int(getattr(c, name)) for c in carriers), default=0))
        self.pressure_peak = max((float(c.pressure_peak) for c in carriers), default=0.0)
        reprs: Dict[int, Any] = {}
        for c in carriers:
            reprs.update(c._reprs)
        self._set_reprs(reprs)
        self._clear_table_outbox()
        self._owner_rank = -1
        self._owner_world = 0
        return self

    def _clear_table_outbox(self) -> None:
        dev = self.device
        self.out_hi = torch.zeros((0,), dtype=torch.int32, device=dev)
        self.out_lo = torch.zeros((0,), dtype=torch.int32, device=dev)
        self.out_val = torch.zeros((0, self._payload_width), dtype=torch.float32, device=dev)
        self._put("out_n", torch.zeros((), dtype=torch.int32))
        self.out_h = 0
        self._bounds = []

    # ------------------------------------------------------- drain / adopt

    def _pre_adopt_commit(self) -> None:
        """Drain-time finalization on the MERGED (logical) table, called by
        ``toolkit.adopt_synced`` before each rank adopts the payload, so
        every decision here is a function of globally merged state:

        1. windowed families commit the pending epoch accumulators as one
           ring column per key WITH traffic this epoch;
        2. the armed admission ladder steps;
        3. the drain epoch advances;
        4. TTL and occupancy eviction run (oldest ``last_seen`` first,
           ties by ascending key hash).
        """
        n = int(self.n_keys)
        win = self.family.window
        wfields = windowed_fields(self.family)
        if wfields and n:
            # ONE window clock: every windowed field shares the per-key
            # epoch cursor and the traffic decision (the OR over the
            # family's traffic fields)
            pend = {f: getattr(self, f"col_{f}")[:n] for f in wfields}
            has = torch.zeros((n,), dtype=torch.bool, device=self.device)
            for f in traffic_fields(self.family):
                has = has | (pend[f] != 0.0)
            cur = (self.epochs_recorded[:n] % win).to(torch.int64)
            rows = torch.arange(n, device=self.device)
            for f in wfields:
                ring = getattr(self, f"ring_{f}").clone()
                ring[rows, cur] = torch.where(has, pend[f], ring[rows, cur])
                self._put(f"ring_{f}", ring)
                col = getattr(self, f"col_{f}").clone()
                col[:n] = 0.0
                self._put(f"col_{f}", col)
            rec = self.epochs_recorded.clone()
            rec[:n] += has.to(torch.int32)
            self._put("epochs_recorded", rec)
        if self._admission is not None:
            self._admission.commit(self)
        self.epoch = int(self.epoch) + 1
        self._evict()
        # this table is the merged view here (or a world-1 working table,
        # where local IS global): the global key count follows the
        # post-eviction union
        self.global_keys = int(self.n_keys)

    def _evict(self) -> None:
        """TTL and occupancy eviction on the logical table (see
        :meth:`_pre_adopt_commit`)."""
        n = int(self.n_keys)
        if n == 0 or (self.ttl is None and self.max_keys is None):
            return
        ls = _as_numpy(self.last_seen[:n]).astype(np.int64)
        keep = np.ones((n,), bool)
        if self.ttl is not None:
            keep &= ls > int(self.epoch) - 1 - int(self.ttl)
        if self.max_keys is not None and int(keep.sum()) > self.max_keys:
            # oldest first, ties by ascending key hash: both merged-state
            # quantities, so the order is deterministic
            alive = np.flatnonzero(keep)
            order = np.lexsort((self._keys[alive], ls[alive]))
            keep[alive[order[: int(keep.sum()) - self.max_keys]]] = False
        dropped = n - int(keep.sum())
        if dropped == 0:
            return
        self._keep_subset(np.flatnonzero(keep))
        self.evictions_total = int(self.evictions_total) + dropped

    def _keep_subset(self, idx: np.ndarray) -> None:
        """Retain only the slot rows at ``idx`` (ascending: slot order is
        key order, and a subset of a sorted set stays sorted)."""
        kept = self._keys[idx]
        n_new = int(kept.size)
        cap = self._slot_capacity(n_new)
        pad = cap - n_new
        idx_dev = torch.from_numpy(idx.astype(np.int64)).to(self.device)
        for name in self._per_key_states():
            if name in ("slot_hi", "slot_lo"):
                continue
            taken = torch.index_select(getattr(self, name), 0, idx_dev)
            widths = (0, 0) * (taken.ndim - 1) + (0, pad)
            self._put(name, torch.nn.functional.pad(taken, widths))
        self._set_slots(kept, cap)
        self._keys = kept
        self.n_keys = n_new
        if self._reprs:
            alive = set(int(x) for x in kept)
            self._set_reprs({k: v for k, v in self._reprs.items() if k in alive})

    def adopt(self, process_group: Optional[Any] = None) -> "MetricTable":
        """Sync and drain in one call (``toolkit.adopt_synced(self,
        group)``): outboxes fold to their owners, windowed epochs commit,
        eviction runs, and this rank's table returns to ``owned keys +
        empty outbox``. Returns the merged (logical) table."""
        from torcheval_tpu_torch.metrics.toolkit import adopt_synced

        return adopt_synced(self, process_group)

    # --------------------------------------------------------- serialization

    def state_dict(self) -> Dict[str, Any]:
        """Trimmed snapshot: live slots (not capacity), the outbox to its
        power-of-two covering bucket, and the host bookkeeping (batch
        boundaries, best-effort key reprs)."""
        n = int(self.n_keys)
        cnt = int(self.out_h)
        keep = _pow2(cnt, 1) if cnt else 0
        sd: Dict[str, Any] = {}
        for name in self._per_key_states():
            sd[name] = getattr(self, name)[:n].clone()
        sd["out_hi"] = self.out_hi[:keep].clone()
        sd["out_lo"] = self.out_lo[:keep].clone()
        sd["out_val"] = self.out_val[:keep].clone()
        sd["out_n"] = self.out_n.clone()
        for name in _HOST_INTS:
            sd[name] = int(getattr(self, name))
        sd["pressure_peak"] = float(self.pressure_peak)
        sd["out_bounds"] = torch.tensor(self._bounds, dtype=torch.int32).reshape(-1)
        sd["key_reprs"] = tuple(sorted(self._reprs.items()))
        return sd

    def load_state_dict(self, state_dict: Dict[str, Any], strict: bool = True) -> None:
        """Load a snapshot. A CARRIER payload (``_owner_rank >= 0``) is
        taken as it is (sync clones, same-world restores); a LOGICAL
        payload (``_owner_rank == -1``) re-slices to this rank's owned
        keys under the configured world with an empty outbox: the
        bit-identical re-hash of a drain or a world-size-change resume.
        Planes may arrive as int32 holders or as the JAX package's
        uint32."""
        sd = dict(state_dict)
        bounds = sd.pop("out_bounds", None)
        reprs = sd.pop("key_reprs", ())
        registered = set(self._state_name_to_default)
        provided = set(sd)
        if strict and registered != provided:
            raise RuntimeError(
                f"Error(s) in loading state_dict for {type(self).__name__}: "
                f"missing keys: {sorted(registered - provided)}, "
                f"unexpected keys: {sorted(provided - registered)}."
            )
        owner_rank = int(_as_numpy(sd.get("_owner_rank", -1)))
        keys = _join_planes(sd["slot_hi"], sd["slot_lo"])
        n = int(_as_numpy(sd.get("n_keys", keys.size)))
        keys = keys[:n]
        rows = {
            name: _as_numpy(sd[name])[:n]
            for name in self._per_key_states()
            if name not in ("slot_hi", "slot_lo") and name in sd
        }
        repr_map = {int(k): v for k, v in (reprs or ())}
        if owner_rank < 0:
            # logical payload: keep only the keys this rank owns NOW
            kept = np.flatnonzero(owner_of(keys, self.world) == self.rank)
            self.global_keys = int(keys.size)
            keys = keys[kept]
            rows = {name: v[kept] for name, v in rows.items()}
            out_h = 0
            ocap = 0
            self._bounds = []
        else:
            self.global_keys = int(_as_numpy(sd.get("global_keys", n)))
            out_h = int(_as_numpy(sd.get("out_h", 0)))
            ocap = _pow2(out_h + 1, _MIN_OUTBOX) if out_h else 0
            self._bounds = (
                [int(b) for b in _as_numpy(bounds).reshape(-1)]
                if bounds is not None
                else ([out_h] if out_h else [])
            )
        if self.world > 1 and int(self.out_hi.shape[0]) >= _MIN_OUTBOX:
            # keep the smallest outbox allocated across drains: an ingest
            # writes its scratch entry there, and a CUDA graph writing the
            # live tensor survives an in-place reload
            ocap = max(ocap, _MIN_OUTBOX)
        out_hi = np.full((ocap,), _SENT32, np.int32)
        out_lo = np.full((ocap,), _SENT32, np.int32)
        out_val = np.zeros((ocap, self._payload_width), np.float32)
        if out_h:
            out_hi[:out_h] = _as_numpy(sd["out_hi"]).astype(np.uint32)[:out_h].view(np.int32)
            out_lo[:out_h] = _as_numpy(sd["out_lo"]).astype(np.uint32)[:out_h].view(np.int32)
            out_val[:out_h] = _as_numpy(sd["out_val"]).astype(np.float32)[:out_h]
        n_live = int(keys.size)
        cap = self._slot_capacity(n_live)
        pad = cap - n_live
        self._set_slots(keys, cap)
        for name, value in rows.items():
            widths = ((0, pad),) + tuple((0, 0) for _ in range(value.ndim - 1))
            dtype = getattr(self, name).dtype
            padded = np.pad(value, widths)
            self._put(name, torch.from_numpy(np.ascontiguousarray(padded)).to(dtype))
        self._put("out_hi", torch.from_numpy(out_hi))
        self._put("out_lo", torch.from_numpy(out_lo))
        self._put("out_val", torch.from_numpy(out_val))
        self._put("out_n", torch.tensor(out_h, dtype=torch.int32))
        self.out_h = out_h
        self._keys = keys
        self.n_keys = n_live
        for name in (
            "epoch", "inserts_total", "evictions_total", "admission_rung",
            "admission_calm", "admission_epoch", "admitted_rows_total",
            "shed_rows_total", "admission_transitions",
        ):
            if name in sd:
                setattr(self, name, int(_as_numpy(sd[name])))
        if "pressure_peak" in sd:
            self.pressure_peak = float(_as_numpy(sd["pressure_peak"]))
        if owner_rank < 0:
            self._owner_rank = int(self.rank)
            self._owner_world = int(self.world)
            if repr_map:
                hashes = np.asarray(sorted(repr_map), np.uint64)
                mine = hashes[owner_of(hashes, self.world) == self.rank]
                self._set_reprs({int(h): repr_map[int(h)] for h in mine})
            else:
                self._set_reprs({})
        else:
            self._owner_rank = owner_rank
            self._owner_world = int(_as_numpy(sd.get("_owner_world", 0)))
            self._set_reprs(repr_map)
        self.__dict__.pop("sync_provenance", None)
        self.__dict__.pop("obs_step", None)
        self.__dict__.pop("admission_provenance", None)
        # replaced state invalidates any published sync-plane snapshot
        # (this override does not call super().load_state_dict)
        self._state_epoch = self._state_epoch + 1

    def _reshard_to_own(self) -> "MetricTable":
        """Re-slice a DESHARDED (logical) table back to this rank's owned
        keys: the tail step of a world-size-change elastic resume (hashes
        are deterministic and ownership is ``hash % new_world``)."""
        if int(self._owner_rank) == self.rank and int(self._owner_world) == self.world:
            return self
        if int(self._owner_rank) >= 0:
            if int(self._owner_world) == 1 and int(self.out_h) == 0:
                # a world-1 carrier IS the logical table
                self._owner_rank = -1
                self._owner_world = 0
            else:
                raise RuntimeError(
                    "reshard requires a desharded (merged) logical table; "
                    f"live state carries rank {int(self._owner_rank)} of "
                    f"world {int(self._owner_world)}"
                )
        self.load_state_dict(self.state_dict())
        return self

    def reset(self) -> "MetricTable":
        super().reset()
        self._keys = np.zeros((0,), np.uint64)
        self._slot_key = torch.zeros((0,), dtype=torch.int64, device=self.device)
        self._bounds = []
        self._set_reprs({})
        self.__dict__.pop("admission_provenance", None)
        return self

    def _set_reprs(self, reprs: Dict[int, Any]) -> None:
        self._reprs = dict(reprs)
        self._repr_hashes = np.asarray(sorted(self._reprs), np.uint64)

    # ------------------------------------------------------------------- obs

    def _logical_state_nbytes(self) -> Dict[str, int]:
        """Per-state LOGICAL bytes for ``obs.memory_report``: per-key
        states scale to the pow2 slot capacity covering the last-known
        global key count (``global_keys``, refreshed at every merge and
        drain), the capacity one world-1 replica would pin; outbox and
        bookkeeping count as live (the per-rank overhead)."""
        from torcheval_tpu_torch.obs.memory import _leaf_bytes

        per_key = set(self._per_key_states())
        n = _pow2(max(int(self.global_keys), int(self.n_keys)), _MIN_SLOTS)
        out: Dict[str, int] = {}
        for name in self._state_name_to_default:
            value = getattr(self, name)
            if name in per_key and isinstance(value, torch.Tensor):
                row = value.element_size()
                for d in value.shape[1:]:
                    row *= int(d)
                out[name] = n * row
            else:
                out[name] = _leaf_bytes(value)
        return out

    def counter_source(self) -> Dict[str, Any]:
        """Occupancy / eviction / outbox / byte gauges for the
        ``obs.CounterRegistry`` (pull-based; zero cost between scrapes)."""
        from torcheval_tpu_torch.obs.memory import per_rank_state_bytes

        rung = int(self.admission_rung)
        ctrl = self._admission
        return {
            "occupancy": int(self.n_keys),
            "global_keys": max(int(self.global_keys), int(self.n_keys)),
            "capacity": int(self.slot_hi.shape[0]),
            "epoch": int(self.epoch),
            "inserts_total": int(self.inserts_total),
            "evictions_total": int(self.evictions_total),
            "outbox_entries": int(self.out_h),
            "per_rank_bytes": int(sum(per_rank_state_bytes(self).values())),
            "logical_bytes": int(sum(self._logical_state_nbytes().values())),
            "admission_rung": rung,
            "sampled_fraction": 1.0 if ctrl is None else ctrl.sampled_fraction(rung),
            "admitted_rows_total": int(self.admitted_rows_total),
            "shed_rows_total": int(self.shed_rows_total),
            "admission_transitions_total": int(self.admission_transitions),
        }

    def track(self, source: str = "metric_table", registry=None) -> None:
        """Register :meth:`counter_source` on an ``obs`` counter registry
        (default: the process registry every exporter scrapes)."""
        from torcheval_tpu_torch.obs.counters import default_registry

        (registry or default_registry()).register(source, self.counter_source)

    def scrape_values(self, limit: Optional[int] = None) -> Dict[str, float]:
        """Per-segment values for the Prometheus exporter:
        ``{value_<sanitized key>: float}`` over (up to ``limit``) live
        slots. Reads values to the host: scrape cadence only."""
        tv = self.compute()
        vals = _as_numpy(tv.values)
        out: Dict[str, float] = {}
        n = len(tv.keys) if limit is None else min(limit, len(tv.keys))
        for k, v in zip(tv.keys[:n], vals[:n]):
            label = tv.reprs.get(int(k), f"{int(k):016x}")
            label = re.sub(r"[^a-zA-Z0-9_]", "_", str(label))
            name = f"value_{label}"
            if name in out:
                # two keys sanitized to one name: disambiguate by hash
                name = f"value_{label}_{int(k) & 0xFFFFFFFF:08x}"
            out[name] = float(v)
        return out

    def track_values(
        self,
        source: str = "metric_table_values",
        registry=None,
        limit: Optional[int] = 1024,
        observe_drift: bool = False,
    ) -> None:
        """Register the per-segment value scrape (``limit`` keys a scrape)
        on an ``obs`` counter registry, with the overload gauges
        ``shed_fraction`` and ``admitted_keys``. ``observe_drift=True``
        also feeds every scraped value into the armed SLO monitor's drift
        series (``<source>/<gauge>``)."""
        from torcheval_tpu_torch.obs.counters import default_registry

        def supplier():
            values = self.scrape_values(limit)
            offered = int(self.admitted_rows_total) + int(self.shed_rows_total)
            values["shed_fraction"] = float(self.shed_rows_total) / offered if offered else 0.0
            values["admitted_keys"] = float(self.n_keys)
            if observe_drift:
                from torcheval_tpu_torch.obs.monitor import current_monitor

                monitor = current_monitor()
                if monitor is not None:
                    for name, value in sorted(values.items()):
                        monitor.observe(f"{source}/{name}", value)
            return values

        (registry or default_registry()).register(source, supplier)

    def gather_key_reprs(self, group, *, adopt: bool = True) -> Dict[int, Any]:
        """Merge every rank's best-effort key reprs in ONE
        ``allgather_object`` so scraped hex hashes resolve to original keys
        cluster-wide. Every member calls it in step; non-members issue no
        collective and get ``{}``. Rank payloads merge in ascending rank
        order (first writer wins per hash). ``adopt=True`` installs the
        merged mapping and lifts ``repr_limit`` to cover it."""
        if not group.is_member:
            return {}
        gathered = group.allgather_object(dict(self._reprs))
        merged: Dict[int, Any] = {}
        for contrib in gathered:
            for h, r in contrib.items():
                merged.setdefault(int(h), r)
        if adopt:
            self.repr_limit = max(self.repr_limit, len(merged))
            self._set_reprs(merged)
        return merged
