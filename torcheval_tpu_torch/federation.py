"""Cross-region eval federation: staleness-tolerant WAN sync.

Counterpart of ``torcheval_tpu/federation.py``: one logical eval spanning
regions. Inside a
region (a pod, a datacenter), the existing synchronous sync stack runs
UNCHANGED: collectives are fast, full-participation, and exact. Between
regions the links are WAN-grade — high latency, flaky, occasionally
partitioned for minutes — so inter-region state exchange must be
*asynchronous and staleness-tolerant*: synchronous intra-region
collectives run under an asynchronous fault-tolerant inter-region exchange
that survives link loss. The piece that makes this
correct for metrics is the ``merge_state()`` contract itself: metric
state is a CRDT-like mergeable object, so a region that went dark catches
up by MERGING a cumulative snapshot — never by replaying messages.

Model
-----

- The world's ranks are partitioned into :class:`RegionSpec` regions.
  Each region syncs intra-region through an ordinary subgroup
  (``group.new_subgroup``) — the same collectives, payloads, and merge
  order as before; the federation adds no collective and no host sync to
  the update path.
- Each :meth:`Federation.exchange` advances the region's **epoch** and
  packs the region-merged state into an epoch-stamped snapshot (the
  ``synclib`` pack codec — same traversal order, same trimming). Region
  leaders exchange snapshots over an unreliable :class:`LinkTransport`
  (mailbox post/poll — never a rendezvous, so a dead peer cannot block).
- The receiver keeps an **epoch ledger** per remote region: the highest
  merged epoch and its snapshot. A message whose epoch is not newer than
  the ledger is discarded — re-delivery and reordering are idempotent
  *by construction* (replacement by max epoch), which is what makes a
  healed partition converge to a state bit-identical to the
  never-partitioned oracle.
- **Deltas**: a sender diffs its current snapshot against the last epoch
  the peer ACKed (4-byte-word sparse diff, crc-verified against the
  reconstructed full payload) and ships whichever is smaller — delta or
  full. Mostly-static large states (confusion matrices, binned
  histograms) ship KBs instead of MBs. A
  base the receiver no longer holds triggers a ``resync`` reply and a
  full snapshot next round — anti-entropy needs ONE cumulative message,
  never a replay.
- **Bounded-staleness reads**: :meth:`Federation.federate` /
  :meth:`Federation.sync_and_compute` return values computed from the
  freshest merged snapshot of every region and attach a
  :class:`FederationProvenance` declaring, per region, the last merged
  epoch, its staleness in exchange rounds, and its wall-clock age.
- **Partition tolerance**: a region whose snapshot has not merged for
  ``partition_after`` rounds is DARK. Under the default ``"quorum"``
  policy the federation degrades to the surviving regions (provenance
  flags the result, a staleness ``AlertEvent`` is emitted, ``/healthz``
  degrades once staleness exceeds ``staleness_503``); ``"raise"``
  raises :class:`RegionPartitionError` instead. Posts to a dark region
  back off exponentially (the ``resilience`` backoff law, in round
  units) — the periodic probe IS the anti-entropy trigger on heal.
- **Crash safety**: the epoch ledger (plus the sender-side snapshot
  history deltas diff against) rides elastic snapshot bundles
  (``elastic.ElasticSession(federation=...)``). Because merges are
  replacement-by-epoch, a crash mid-exchange can neither double-count
  (the re-delivered epoch is discarded by the restored ledger) nor drop
  a delta (un-acked state is re-derived from the cumulative snapshot).

Observability: every exchange emits ``RegionSyncEvent`` records
(recorder-gated), per-region staleness gauges ride the counter registry (``federation`` source:
``region_staleness_epochs/<region>``, ``region_last_merge_age/<region>``),
and un-acked inter-region deltas are tracked as long-lived flight records
(``obs/flight.py``) so ``diff_flight_rings`` names the stalled REGION,
not just a stuck thread. Tracked link records are exempt from the stall
watchdog's collective deadline (they legitimately stay in flight for the
whole inter-exchange interval); their health authority is the staleness
bound and the ``/healthz`` ``stale-region`` probe.

The wire carries no tensors: messages are pickled dicts of numpy arrays
and bytes, as in the JAX package, so the two packages' ledgers and
snapshots cross-load. Region groups are made on every rank, for every
region, in the same order (``torch.distributed.new_group``'s contract); a
``reform`` onto survivors builds its groups inside
``distributed.members_only()``, so the dead take no part.
"""

from __future__ import annotations

import pickle
import threading
import time
import warnings
from dataclasses import dataclass, field
from typing import (
    Any,
    Dict,
    List,
    NamedTuple,
    Optional,
    Sequence,
    Tuple,
    Union,
)

import numpy as np

from torcheval_tpu_torch.distributed import ProcessGroup, _check_subgroup_ranks, members_only
from torcheval_tpu_torch.obs.flight import FLIGHT as _FLIGHT
from torcheval_tpu_torch.obs.recorder import RECORDER as _OBS
from torcheval_tpu_torch.resilience import quorum_count

__all__ = [
    "Federation",
    "FederationProvenance",
    "InProcessLinkBus",
    "KVLinkTransport",
    "LinkHealth",
    "LinkTransport",
    "RegionPartitionError",
    "RegionSpec",
    "RegionStatus",
    "current_federation",
    "default_link_bus",
]


class RegionPartitionError(RuntimeError):
    """The federation cannot satisfy its policy: a region is dark under
    ``policy="raise"``, or fewer regions than the quorum have ever
    contributed a snapshot."""


class RegionSpec(NamedTuple):
    """One region of the federation.

    ``ranks`` are ranks OF THE GROUP the federation is built on
    (``0 .. group.world_size - 1``), ascending; the first rank is the
    region LEADER (it drives the inter-region links). Regions must
    partition the group's ranks.
    """

    name: str
    ranks: Tuple[int, ...]


class RegionStatus(NamedTuple):
    """One region's view in a :class:`FederationProvenance` (and from
    :meth:`Federation.region_statuses`).

    ``epoch`` is the region's last merged epoch (its OWN epoch counter;
    0 = never merged). ``staleness_epochs`` counts THIS region's exchange
    rounds since that merge (0 for the local region);
    ``age_seconds`` is the wall-clock age of the merge (``inf`` when
    never merged). ``dark`` means staleness exceeded the federation's
    ``partition_after`` bound — the region is treated as partitioned.
    """

    name: str
    epoch: int
    staleness_epochs: int
    age_seconds: float
    dark: bool
    is_self: bool = False


class FederationProvenance(NamedTuple):
    """Which regions contributed to a federated result (attached to
    merged metrics as ``metric.federation_provenance``). ``degraded`` is
    True whenever any region's snapshot is missing or dark — the result
    is the surviving regions' merge, mirroring the quorum semantics of
    ``resilience.SyncProvenance``."""

    regions: Tuple[RegionStatus, ...]
    merged_regions: Tuple[str, ...]
    degraded: bool
    policy: str
    epoch: int


# --------------------------------------------------------------------------
# Link transports
# --------------------------------------------------------------------------


class LinkTransport:
    """Unreliable directed mailbox between region leaders.

    Deliberately NOT a collective: :meth:`post` never waits for the peer
    and :meth:`poll` returns whatever has arrived (possibly nothing) —
    a dead region can therefore never block a live one. Delivery may
    duplicate, reorder, delay, or drop; the federation's epoch ledger is
    correct under all four.
    """

    def post(self, src: str, dst: str, blob: bytes) -> None:
        """Queue one message from region ``src`` to region ``dst``."""
        raise NotImplementedError

    def poll(self, dst: str) -> List[bytes]:
        """Drain messages addressed to region ``dst`` (arrival order)."""
        raise NotImplementedError

    def close(self) -> None:
        """Release transport resources (idempotent)."""


class InProcessLinkBus(LinkTransport):
    """Thread-safe in-process mailbox — the transport for test worlds
    (``ThreadWorld``: every region leader lives in this process) and for
    single-process multi-region simulation. Chaos wraps it
    (``utils.test_utils.ChaosLinkTransport``) for the fault schedules."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._mail: Dict[str, List[bytes]] = {}  # tev: guarded-by=_lock

    def post(self, src: str, dst: str, blob: bytes) -> None:
        with self._lock:
            self._mail.setdefault(dst, []).append(bytes(blob))

    def poll(self, dst: str) -> List[bytes]:
        with self._lock:
            return self._mail.pop(dst, [])


_DEFAULT_BUS: Optional[InProcessLinkBus] = None  # tev: guarded-by=_DEFAULT_BUS_LOCK
_DEFAULT_BUS_LOCK = threading.Lock()


def default_link_bus() -> InProcessLinkBus:
    """The process-global :class:`InProcessLinkBus` every federation in
    this process shares by default — which is exactly what in-process
    rank worlds (``ThreadWorld``) need for their leaders to reach each
    other."""
    global _DEFAULT_BUS
    with _DEFAULT_BUS_LOCK:
        if _DEFAULT_BUS is None:
            _DEFAULT_BUS = InProcessLinkBus()
        return _DEFAULT_BUS


class KVLinkTransport(LinkTransport):
    """Inter-region mailboxes over the job's ``torch.distributed`` store
    (``distributed.coordination_client()``) — the multi-process transport
    (region leaders are separate processes that already rendezvoused
    through it).

    Each directed link is a sequence of keys
    ``torcheval_fed/<tag>/<src>-><dst>/<n>`` plus a sender-maintained
    **head pointer** (``.../head`` = the count of messages ever posted).
    The head is what makes the link RESTART-SAFE with no persisted local
    state: a restarted sender reads the head to resume its numbering
    (never reusing a key the receiver already consumed), and a restarted
    receiver reads the head and walks forward, treating absent keys
    (already consumed pre-crash, or lost) as skipped — the federation's
    epoch ledger tolerates loss, so skipping is always safe. Every
    read is bounded by ``poll_timeout`` under the resilience deadline
    worker (``bounded_call``), so a wedged store cannot hang the eval
    loop. Latency is a store round trip — right for the occasional
    inter-region cadence, wrong for anything per-step.
    """

    def __init__(self, *, tag: str = "0", poll_timeout: float = 5.0) -> None:
        self.tag = str(tag)
        self.poll_timeout = float(poll_timeout)
        self._sent: Dict[Tuple[str, str], int] = {}
        self._consumed: Dict[str, Dict[str, int]] = {}

    def _client(self):
        from torcheval_tpu_torch.distributed import coordination_client

        return coordination_client()

    def _key(self, src: str, dst: str, n: int) -> str:
        return f"torcheval_fed/{self.tag}/{src}->{dst}/{n}"

    def _head_key(self, src: str, dst: str) -> str:
        return f"torcheval_fed/{self.tag}/{src}->{dst}/head"

    def _get(self, key: str) -> Optional[bytes]:
        """One bounded KV read; ``None`` for absent-or-wedged (both end
        the attempt — the protocol is staleness-tolerant)."""
        from torcheval_tpu_torch.resilience import SyncTimeoutError, bounded_call

        store = self._client()
        try:
            return bounded_call(
                lambda: bytes(store.get(key)) if store.check([key]) else None,
                self.poll_timeout,
            )
        except SyncTimeoutError:
            return None  # store wedged: give up this attempt

    def _read_head(self, src: str, dst: str) -> int:
        raw = self._get(self._head_key(src, dst))
        if raw is None:
            return 0
        try:
            return int(raw.decode("ascii"))
        except ValueError:
            return 0

    def post(self, src: str, dst: str, blob: bytes) -> None:
        link = (src, dst)
        if link not in self._sent:
            # restart-safe numbering: resume ABOVE whatever was ever
            # posted on this link (a reused key would be invisible to a
            # receiver that already consumed past it)
            self._sent[link] = self._read_head(src, dst)
        n = self._sent[link]
        self._sent[link] = n + 1
        store = self._client()
        store.set(self._key(src, dst, n), bytes(blob))
        store.set(self._head_key(src, dst), str(n + 1).encode("ascii"))

    def poll(self, dst: str) -> List[bytes]:
        store = self._client()
        counts = self._consumed.setdefault(dst, {})
        out: List[bytes] = []
        for src in sorted(self._known_sources(dst)):
            head = self._read_head(src, dst)
            # a restarted receiver (consumed counter reset to 0) walks
            # forward from a bounded window below the head, not from the
            # dawn of the link: older messages are superseded by newer
            # cumulative snapshots, and each absent key costs a bounded
            # probe — an unbounded walk would turn recovery into
            # minutes of KV round-trips
            n = max(counts.get(src, 0), head - 64)
            while n < head:
                blob = self._get(self._key(src, dst, n))
                if blob is not None:
                    out.append(blob)
                    store.delete_key(self._key(src, dst, n))
                # ABSENT keys advance too: consumed pre-crash or lost —
                # the epoch ledger tolerates loss, blocking on a gap
                # would stall the link forever
                n += 1
            counts[src] = max(counts.get(src, 0), n)
        return out

    def _known_sources(self, dst: str) -> List[str]:
        # the federation registers the peer set at construction so the
        # receiver knows which directed links to scan
        return list(self._consumed.get(dst, {})) or list(self._peers)

    _peers: Tuple[str, ...] = ()

    def register_peers(self, dst: str, peers: Sequence[str]) -> None:
        """Called by :class:`Federation` so :meth:`poll` knows which
        directed links target ``dst``."""
        counts = self._consumed.setdefault(dst, {})
        for p in peers:
            counts.setdefault(p, 0)


# --------------------------------------------------------------------------
# Wire codec: epoch-stamped snapshots and word-sparse deltas
# --------------------------------------------------------------------------


def _word_view(buf: np.ndarray) -> np.ndarray:
    """uint8 payload -> uint32 word view, zero-padded to a word boundary
    (both sides of a diff have equal length, so the padding cancels)."""
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    pad = (-buf.size) % 4
    if pad:
        buf = np.concatenate([buf, np.zeros(pad, dtype=np.uint8)])
    return buf.view(np.uint32)


def encode_delta(base: np.ndarray, cur: np.ndarray) -> Optional[Dict[str, Any]]:
    """4-byte-word sparse diff of two equal-length uint8 payloads, or
    ``None`` when the diff would not beat the full payload (dense change,
    or payloads too large for uint32 indexing). Reconstruction via
    :func:`apply_delta` is bit-exact for any state dtype — the diff is
    over the packed wire bytes, not state semantics."""
    if base.size != cur.size or cur.size >= (1 << 32):
        return None
    bw, cw = _word_view(base), _word_view(cur)
    idx = np.flatnonzero(bw != cw)
    # 8 bytes per changed word on the wire; only ship when it wins
    if idx.size * 8 >= cur.size:
        return None
    return {
        "idx": idx.astype(np.uint32),
        "words": np.ascontiguousarray(cw[idx]),
        "size": int(cur.size),
    }


def apply_delta(base: np.ndarray, delta: Dict[str, Any]) -> np.ndarray:
    """Inverse of :func:`encode_delta`: reconstruct the full payload from
    the receiver's copy of the base."""
    words = _word_view(base).copy()
    words[np.asarray(delta["idx"], dtype=np.uint32)] = np.asarray(
        delta["words"], dtype=np.uint32
    )
    return words.view(np.uint8)[: int(delta["size"])].copy()


@dataclass
class LinkHealth:
    """Per-link observability counters (the federation sibling of
    ``resilience.SyncHealth``)."""

    posts: int = 0
    deltas_sent: int = 0
    fulls_sent: int = 0
    delta_bytes: int = 0
    full_bytes: int = 0
    merges: int = 0
    acks_seen: int = 0
    duplicates: int = 0
    resyncs: int = 0
    crc_failures: int = 0
    partitions: int = 0
    heals: int = 0

    def as_dict(self) -> Dict[str, int]:
        return dict(self.__dict__)


class _LinkState:
    """One remote region's ledger + sender bookkeeping (leader side)."""

    __slots__ = (
        "name", "merged_epoch", "merged_meta", "merged_buf",
        "merged_at_round", "merged_wall", "acked", "force_full", "dark",
        "probe_attempt", "next_probe_round", "health", "flight",
        "flight_epoch",
    )

    def __init__(self, name: str) -> None:
        self.name = name
        self.merged_epoch = 0  # peer's highest merged epoch
        self.merged_meta: Any = None
        self.merged_buf: Optional[np.ndarray] = None
        self.merged_at_round = 0  # MY epoch when that merge landed
        self.merged_wall = 0.0
        self.acked = 0  # highest of MY epochs the peer confirmed merging
        self.force_full = True  # first contact (and resync) ships full
        self.dark = False
        self.probe_attempt = 0
        self.next_probe_round = 0
        self.health = LinkHealth()
        self.flight = None  # open obs/flight record of the un-acked delta
        self.flight_epoch = 0


def _backoff_rounds(attempt: int, limit: int) -> int:
    """Exponential post backoff to a dark region, in exchange-round
    units: ``resilience.backoff_delay`` — the one backoff law of the
    resilience stack — with a round quantum (base 1 round, capped at
    ``limit``) and no jitter, because round schedules must replay
    deterministically under the chaos harness."""
    from torcheval_tpu_torch.resilience import backoff_delay

    rounds = backoff_delay(
        attempt, base=1.0, maximum=float(max(limit, 1)), jitter=0.0
    )
    return max(1, int(rounds))


# --------------------------------------------------------------------------
# Federation
# --------------------------------------------------------------------------

_CURRENT: Optional["Federation"] = None  # tev: guarded-by=_CURRENT_LOCK
_CURRENT_LOCK = threading.Lock()


def current_federation() -> Optional["Federation"]:
    """The most recently armed :class:`Federation` in this process (read
    by ``obs.server.healthz_payload`` for the staleness probe). One
    federation per process is the production shape (rank-per-process);
    in-process test worlds share this slot — last armed wins."""
    return _CURRENT  # tev: disable=guarded-field -- single-reference read, atomic under the GIL; the healthz probe tolerates a one-scrape-stale federation


class Federation:
    """Two-tier region federation over a ``ProcessGroup`` (module
    docstring has the model).

    Args:
        group: the whole-world group (``MultiHostGroup``, ``ThreadWorld``
            views, any group supporting ``new_subgroup``). Construct the
            federation on EVERY rank, in the same order, with the same
            ``regions`` — the subgroup-construction contract.
        regions: ``RegionSpec``\\ s (or ``(name, ranks)`` pairs)
            partitioning ``group``'s ranks. Canonical region order is
            ascending leader rank — the cross-region MERGE order, which
            is what makes every rank (and the never-partitioned oracle)
            merge identically.
        transport: inter-region :class:`LinkTransport`; default
            :func:`default_link_bus` in single-process worlds,
            :class:`KVLinkTransport` under a multi-host group.
        partition_after: exchange rounds without a merge before a region
            is declared dark (default
            ``config.federation_staleness_epochs()``).
        staleness_503: staleness bound (rounds) past which ``/healthz``
            degrades to 503 (default: ``partition_after``).
        policy: ``"quorum"`` (default — degrade to surviving regions,
            provenance flagged) or ``"raise"``.
        quorum: minimum fraction of regions that must contribute once a
            partition is detected (default ``config.sync_quorum()``):
            with any region DARK, fewer contributing regions than the
            quorum raises :class:`RegionPartitionError` even under
            ``"quorum"`` — mirroring ``ResilientGroup``. Regions that
            have never contributed but are still inside the staleness
            bound (cold start) degrade with provenance instead.
        history: sender-side packed snapshots retained for delta bases
            (a peer acked further back than this receives a full).
        backoff_limit: cap (in rounds) of the dark-region post backoff.

    Examples::

        >>> fed = Federation(group, [("us", (0, 1)), ("eu", (2, 3))])
        >>> for step, batch in enumerate(loader):
        ...     update_collection(metrics, *batch)      # untouched hot path
        ...     if step % 100 == 99:
        ...         values = fed.sync_and_compute(metrics)
        ...         prov = fed.last_provenance           # staleness per region
    """

    def __init__(
        self,
        group: ProcessGroup,
        regions: Sequence[Union[RegionSpec, Tuple[str, Sequence[int]]]],
        *,
        transport: Optional[LinkTransport] = None,
        partition_after: Optional[int] = None,
        staleness_503: Optional[int] = None,
        policy: str = "quorum",
        quorum: Optional[float] = None,
        history: int = 8,
        backoff_limit: int = 8,
    ) -> None:
        from torcheval_tpu_torch import config

        from torcheval_tpu_torch.distributed import LocalReplicaGroup

        if isinstance(group.unwrap(), LocalReplicaGroup):
            raise TypeError(
                "Federation needs a rank-per-process (or rank-per-thread) "
                "group; a LocalReplicaGroup's one-controller replica lists "
                "have no per-rank leaders to drive inter-region links"
            )
        specs = []
        for r in regions:
            name, ranks = (r.name, r.ranks) if isinstance(r, RegionSpec) else r
            specs.append(
                RegionSpec(str(name), _check_subgroup_ranks(ranks, group.world_size))
            )
        if len({s.name for s in specs}) != len(specs):
            raise ValueError(
                f"region names must be unique, got {[s.name for s in specs]}"
            )
        covered = sorted(r for s in specs for r in s.ranks)
        if covered != list(range(group.world_size)):
            raise ValueError(
                f"regions {[(s.name, list(s.ranks)) for s in specs]} must "
                f"partition group ranks 0..{group.world_size - 1}"
            )
        # canonical order = ascending leader rank (the merge order; an
        # unsorted spec list would merge regions differently per caller)
        specs.sort(key=lambda s: s.ranks[0])
        self.regions: Tuple[RegionSpec, ...] = tuple(specs)
        # the construction-time membership (reform() filters from this,
        # so a rejoin at the full world restores the original regions)
        self._full_specs: Tuple[RegionSpec, ...] = self.regions
        self._group = group
        if policy not in ("quorum", "raise"):
            raise ValueError(
                f"federation policy must be 'quorum' or 'raise', got {policy!r}"
            )
        self.policy = policy
        self.partition_after = (
            config.federation_staleness_epochs()
            if partition_after is None
            else int(partition_after)
        )
        if self.partition_after < 1:
            raise ValueError(
                f"partition_after must be >= 1 round, got {partition_after}"
            )
        self.staleness_503 = (
            self.partition_after if staleness_503 is None else int(staleness_503)
        )
        self.quorum = config.sync_quorum() if quorum is None else float(quorum)
        if not 0.0 < self.quorum <= 1.0:
            raise ValueError(f"quorum must be in (0, 1], got {self.quorum}")
        self.history = max(1, int(history))
        self.backoff_limit = max(1, int(backoff_limit))

        self.epoch = 0
        self.exchanges = 0
        self.last_provenance: Optional[FederationProvenance] = None
        self._history: Dict[int, Tuple[Any, np.ndarray]] = {}
        self._closed = False

        if not group.is_member:
            # the documented construct-on-every-process contract: a
            # non-member gets an inert handle (same shape as subgroups)
            self.my_region = None
            self.region_group = None
            self.is_leader = False
            self._links = {}
            self.transport = transport
            self._owns_transport = False
            return

        me = group.rank
        mine = next((s for s in self.regions if me in s.ranks), None)
        if mine is None:  # unreachable given the partition check
            raise ValueError(f"rank {me} is in no region")
        self.my_region: Optional[RegionSpec] = mine
        # intra-region sync runs on this subgroup, through the existing
        # toolkit path, UNCHANGED — the federation never wraps or
        # decorates it. Every rank makes every region's group, in region
        # order: torch.distributed.new_group needs every process
        subgroups = [group.new_subgroup(s.ranks) for s in self.regions]
        self.region_group = subgroups[self.regions.index(mine)]
        self.is_leader = me == mine.ranks[0]
        self._links: Dict[str, _LinkState] = {
            s.name: _LinkState(s.name)
            for s in self.regions
            if s.name != mine.name
        }
        # per-link epoch of the last FULL snapshot this leader broadcast
        # to its region members (quiet links broadcast light stamps only)
        self._last_broadcast: Dict[str, int] = {}
        # close() releases only a transport this federation created for
        # itself (the fresh multi-host KV transport); explicitly passed
        # transports and the shared process-global bus belong to the
        # caller / to every other federation in the process
        self._owns_transport = False
        if transport is None:
            transport = self._default_transport()
            self._owns_transport = not isinstance(transport, InProcessLinkBus)
        self.transport = transport
        register = getattr(transport, "register_peers", None)
        if register is not None and self.is_leader:
            register(mine.name, [s.name for s in self.regions if s is not mine])
        self._arm()

    # ------------------------------------------------------------- plumbing

    def _default_transport(self) -> LinkTransport:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            return KVLinkTransport()
        return default_link_bus()

    @property
    def is_member(self) -> bool:
        return self.my_region is not None

    @property
    def region_names(self) -> Tuple[str, ...]:
        return tuple(s.name for s in self.regions)

    def _arm(self) -> None:
        global _CURRENT
        with _CURRENT_LOCK:
            _CURRENT = self
        from torcheval_tpu_torch.obs.counters import default_registry

        default_registry().register("federation", self._counter_source)

    def close(self) -> None:
        """Disarm: release the ``current_federation`` slot and
        unregister the counter source — but ONLY when this federation is
        still the armed one (a later-armed federation's gauges must not
        vanish because an earlier one closed out of order — the
        in-process test-world shape). Idempotent."""
        global _CURRENT
        if self._closed:
            return
        self._closed = True
        was_current = False
        with _CURRENT_LOCK:
            if _CURRENT is self:
                _CURRENT = None
                was_current = True
        if was_current:
            from torcheval_tpu_torch.obs.counters import default_registry

            default_registry().unregister("federation")
        if self.transport is not None and self._owns_transport:
            self.transport.close()

    # --------------------------------------------------------------- reform

    def reform(
        self,
        survivors: Sequence[int],
        process_group: Optional[ProcessGroup] = None,
    ) -> None:
        """Re-form region membership onto the surviving ranks — the
        federation leg of a ``failover.FailureDomain`` recovery (and of
        the later rejoin, where ``survivors`` is the full rank range
        again and the construction-time regions are restored).

        Every surviving member calls this with the same survivor set.
        Each region keeps its surviving ranks (ranks stay numbered in
        the CONSTRUCTION group — subgroups re-derive from it, so a
        shrunken region's intra-region sync simply excludes the dead); a
        region whose ranks all died leaves the federation entirely.
        Leadership falls to each region's lowest surviving rank. A
        (re)installed leader marks every link ``force_full``: its delta
        bases died with the old leader, and the existing ``resync``
        anti-entropy + full-snapshot first contact rebuild them — no new
        protocol. Barrier-free: no collective is issued here; the next
        ``exchange()`` runs the first one on the re-formed region group.

        ``process_group`` is accepted for interface symmetry with
        :meth:`torcheval_tpu_torch.syncplane.SyncPlane.reform` and ignored:
        region specs are bound to construction-group numbering."""
        del process_group
        if not self.is_member:
            return
        self._check_open()
        alive = tuple(sorted(int(r) for r in survivors))
        me = self._group.rank
        if me not in alive:
            raise ValueError(
                f"rank {me} is not among the surviving ranks {alive}"
            )
        specs = [
            RegionSpec(s.name, tuple(r for r in s.ranks if r in alive))
            for s in self._full_specs
        ]
        specs = [s for s in specs if s.ranks]
        specs.sort(key=lambda s: s.ranks[0])
        self.regions = tuple(specs)
        mine = next(s for s in self.regions if me in s.ranks)
        self.my_region = mine
        # only the survivors make it: the dead take no part
        with members_only():
            self.region_group = self._group.new_subgroup(mine.ranks)
        self.is_leader = me == mine.ranks[0]
        peers = tuple(s.name for s in self.regions if s.name != mine.name)
        self._links = {
            name: self._links.get(name) or _LinkState(name)
            for name in peers
        }
        if self.is_leader:
            # whether newly installed or continuing: ship full snapshots
            # until fresh acks re-establish delta bases (a continuing
            # leader's bases may predate the peers' own reforms)
            for link in self._links.values():
                link.force_full = True
            self._last_broadcast = {}
            register = getattr(self.transport, "register_peers", None)
            if register is not None:
                register(mine.name, list(peers))

    # ---------------------------------------------------------- status reads

    def region_statuses(self) -> Tuple[RegionStatus, ...]:
        """Per-region staleness view, region order (the bounded-staleness
        declaration every federated read carries)."""
        now = time.time()
        out = []
        for spec in self.regions:
            if self.my_region is not None and spec.name == self.my_region.name:
                out.append(
                    RegionStatus(spec.name, self.epoch, 0, 0.0, False, True)
                )
                continue
            link = self._links.get(spec.name)
            if link is None:
                out.append(
                    RegionStatus(spec.name, 0, self.epoch, float("inf"), True)
                )
                continue
            stale = self.epoch - link.merged_at_round
            age = (
                now - link.merged_wall if link.merged_epoch else float("inf")
            )
            out.append(
                RegionStatus(
                    spec.name, link.merged_epoch, stale, age, link.dark
                )
            )
        return tuple(out)

    def max_staleness_epochs(self) -> int:
        """Worst remote-region staleness in exchange rounds (0 when no
        remote regions exist or none has ever lagged)."""
        stale = [
            s.staleness_epochs for s in self.region_statuses() if not s.is_self
        ]
        return max(stale, default=0)

    def stale_for_healthz(self) -> bool:
        """True when any region's staleness exceeds ``staleness_503`` —
        the ``/healthz`` 503 condition (``obs.server.healthz_payload``)."""
        if not self.is_member or len(self.regions) < 2:
            return False
        # epoch 0 = the federation has not exchanged yet: not stale, just
        # not started (a fresh process must not be born unhealthy)
        return self.epoch > 0 and self.max_staleness_epochs() > self.staleness_503

    def link_health(self, region: str) -> LinkHealth:
        """Counters for the link to ``region``."""
        return self._links[region].health

    def _counter_source(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "epoch": self.epoch,
            "regions": len(self.regions),
            "exchanges": self.exchanges,
            "dark_regions": sum(
                1 for s in self.region_statuses() if s.dark and not s.is_self
            ),
        }
        totals = LinkHealth()
        for link in self._links.values():
            for k, v in link.health.as_dict().items():
                setattr(totals, k, getattr(totals, k) + v)
        out.update(totals.as_dict())
        for s in self.region_statuses():
            if s.is_self:
                continue
            out[f"region_staleness_epochs/{s.name}"] = s.staleness_epochs
            age = s.age_seconds
            out[f"region_last_merge_age/{s.name}"] = (
                -1.0 if age == float("inf") else round(age, 3)
            )
        return out

    def exchange_interval(self, base: int) -> int:
        """Steps between federation rounds under the current admission
        ladder AND the tightest armed per-tenant staleness budget:
        ``base`` while ingest is healthy, halved per armed degradation
        rung (``base >> rung``), then capped at the smallest
        ``staleness_epochs=`` any armed table declared
        (:func:`torcheval_tpu_torch.table.tightest_staleness_budget`) — a
        latency-sensitive tenant pulls exchanges forward for its whole
        region instead of riding the global shed rung only. Floor 1.

        Overload and WAN cadence pull the SAME lever in opposite
        directions: an overloaded region is exactly the one whose
        pending outbox/staleness grows fastest, so when any local table
        escalates (:func:`torcheval_tpu_torch.table.shedding_status`) the
        region drains MORE often — shrinking both its own memory
        pressure and the staleness its peers observe. Callers that run
        ``exchange()`` on a step cadence poll this between rounds; the
        decision is per-region local state, no collective."""
        from torcheval_tpu_torch.table._admission import max_armed_rung
        from torcheval_tpu_torch.table.table import tightest_staleness_budget

        base = int(base)
        if base < 1:
            raise ValueError(f"base interval must be >= 1, got {base}")
        interval = max(1, base >> max_armed_rung())
        budget = tightest_staleness_budget()
        if budget:
            interval = min(interval, max(1, int(budget)))
        return interval

    # -------------------------------------------------------------- exchange

    def exchange(
        self,
        metrics: Union[Dict[str, Any], Any],
        *,
        on_failure: Optional[str] = None,
        plane: Optional[Any] = None,
    ) -> Dict[str, Any]:
        """One federation round: intra-region sync (the existing
        synchronous path, unchanged), advance this region's epoch, pack
        the region snapshot, and — on the leader — drain incoming
        inter-region messages and post epoch-stamped deltas to every
        peer region (backed off while a peer is dark). Ends with ONE
        intra-region broadcast so every member holds the same remote
        ledger (the "every rank returns the same value" contract).

        Returns the region-synced ``{name: Metric}`` collection (its
        ``sync_provenance`` is the intra-region sync's). Non-members
        return the input untouched.

        ``plane`` (a :class:`~torcheval_tpu_torch.syncplane.SyncPlane` built
        over THIS region group and this live collection) replaces the
        blocking intra-region state sync with the plane's freshest
        merged snapshot: one tiny version-agreement gather (a tuple of
        ints per member) picks the newest version every member still
        retains VALIDLY (capture epochs matching the live metrics —
        reset/restore invalidate), and each member packs that snapshot —
        bit-identical across members, because a plane version is one
        deterministic merge of one collective round. The returned
        collection then carries the plane's bounded-staleness
        ``sync_provenance``. Members that cannot agree on a valid
        version (plane cold, snapshot evicted, post-reset) fall back to
        the blocking sync — the decision is computed from the gathered
        windows, so every member takes the same path.
        """
        from torcheval_tpu_torch.metrics.metric import Metric
        from torcheval_tpu_torch.metrics.toolkit import get_synced_metric_collection

        original = metrics
        if isinstance(metrics, Metric):
            metrics = {"_metric": metrics}
        if not self.is_member:
            # untouched AND in the caller's original shape (a bare
            # Metric must not come back wrapped in the internal dict)
            return original
        self._check_open()
        synced = None
        if plane is not None:
            synced = self._plane_synced(plane, metrics)
        if synced is None:
            synced = get_synced_metric_collection(
                metrics, self.region_group, on_failure=on_failure
            )
        self.epoch += 1
        self.exchanges += 1
        self._history[self.epoch] = self._pack_region_snapshot(synced)
        for old in [e for e in self._history if e <= self.epoch - self.history]:
            del self._history[old]
        if self.is_leader:
            self._drain_incoming()
            self._post_updates()
            self._refresh_dark_flags()
        self._broadcast_ledger()
        return synced

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("Federation is closed")

    def _plane_synced(
        self, plane: Any, metrics: Dict[str, Any]
    ) -> Optional[Dict[str, Any]]:
        """The region-synced collection off the sync plane — or ``None``
        when the members cannot agree on a valid retained version (the
        caller then runs the blocking sync; the decision is a pure
        function of the gathered windows, so every member agrees on
        WHICH path runs — divergence here would be a collective-sequence
        split)."""
        from torcheval_tpu_torch.metrics.toolkit import clone_metric

        if tuple(plane.ranks) != tuple(self.region_group.ranks):
            raise ValueError(
                "exchange(plane=...) needs a plane built over this "
                f"federation's region group (plane ranks "
                f"{tuple(plane.ranks)}, region ranks "
                f"{tuple(self.region_group.ranks)}) — the plane's rounds "
                "are the intra-region sync being replaced"
            )
        for name, m in metrics.items():
            if plane.metrics.get(name) is not m:
                raise ValueError(
                    f"exchange(plane=...) metric {name!r} is not the live "
                    "instance the plane was built over — snapshot "
                    "invalidation validates against the plane's instances"
                )
        # snapshot the retained records BEFORE advertising them: a
        # concurrent plane round cannot evict what this dict holds
        retained = plane.retained()
        valid = sorted(
            version
            for version, record in retained.items()
            if all(
                record.epochs.get(name) == m._state_epoch
                for name, m in metrics.items()
            )
        )
        window = (valid[0], valid[-1]) if valid else (0, 0)
        # ONE tiny collective (a 2-int tuple per member) instead of the
        # full state sync — the whole point of the plane-fed exchange
        windows = self.region_group.allgather_object(window)
        version = min(hi for _, hi in windows)
        if any(lo == 0 for lo, _ in windows) or version < max(
            lo for lo, _ in windows
        ):
            return None  # cold / evicted / invalidated somewhere: block
        record = retained[version]
        now = time.time()
        provenance = record.base._replace(
            version=version,
            rounds_behind=max(0, plane.publishes - record.generation),
            wall_age_seconds=max(0.0, now - record.wall),
        )
        # clones: the caller may merge into the synced collection, and the
        # plane's retained snapshot must stay immutable
        synced = {
            name: clone_metric(record.metrics[name]) for name in metrics
        }
        for m in synced.values():
            m.sync_provenance = provenance
        return synced

    def _pack_region_snapshot(
        self, synced: Dict[str, Any]
    ) -> Tuple[Any, np.ndarray]:
        """Pack the region-merged collection with the synclib codec —
        every member packs bit-identical bytes (the intra-region sync's
        merged states are rank-identical by construction, and the
        per-family wire-ladder rungs are rank-consistent: the configured
        ladder is process-global config and breach caps derive from the
        merged drift sketches every member shares)."""
        from torcheval_tpu_torch import wire as wirelib
        from torcheval_tpu_torch.metrics import synclib

        states = {
            name: m._sync_state_dict() for name, m in synced.items()
        }
        rungs = {
            name: wirelib.effective_rung(type(m).__name__)
            for name, m in synced.items()
        }
        order = synclib.metrics_traversal_order(states)
        meta, flat = synclib._pack_rank_states(states, order, rungs)
        return (order, meta), np.asarray(flat, dtype=np.uint8)

    def _unpack_region_snapshot(
        self, template: Dict[str, Any], meta: Any, buf: np.ndarray
    ) -> Dict[str, Dict[str, Any]]:
        from torcheval_tpu_torch.metrics import synclib

        order, state_meta = meta
        states = {name: m._sync_state_dict() for name, m in template.items()}
        return synclib._unpack_rank_states(
            states, order, state_meta, np.asarray(buf, dtype=np.uint8)
        )

    # ------------------------------------------------------------- messaging

    def _post(self, dst: str, msg: Dict[str, Any]) -> None:
        self.transport.post(self.my_region.name, dst, pickle.dumps(msg))

    def _post_updates(self) -> None:
        from torcheval_tpu_torch.metrics import synclib

        me = self.my_region.name
        meta, buf = self._history[self.epoch]
        # integrity rides the POST-DEQUANTIZE canonical bytes, not the
        # wire bytes: under a lossy ladder rung the receiver merges the
        # dequantized reconstruction, so that is what the crc must pin
        # (synclib.canonical_crc; one per epoch, shared by every peer)
        crc = synclib.canonical_crc(meta[0], meta[1], buf)
        for peer, link in self._links.items():
            if link.dark and self.epoch < link.next_probe_round:
                continue  # backed off: probe later
            msg: Dict[str, Any] = {
                "kind": "full",
                "src": me,
                "dst": peer,
                "epoch": self.epoch,
                # piggyback ack: the highest of THEIR epochs I merged
                "ack": link.merged_epoch,
                "meta": meta,
                "crc": crc,
            }
            delta = None
            base = self._history.get(link.acked)
            if (
                not link.force_full
                and link.acked > 0
                and base is not None
                and base[0] == meta  # identical traversal/meta framing
            ):
                delta = encode_delta(base[1], buf)
            if delta is not None:
                msg.update(kind="delta", base=link.acked, delta=delta)
                wire = delta["idx"].nbytes + delta["words"].nbytes
                link.health.deltas_sent += 1
                link.health.delta_bytes += wire
            else:
                msg["buf"] = buf
                wire = int(buf.nbytes)
                link.health.fulls_sent += 1
                link.health.full_bytes += wire
            link.health.posts += 1
            self._post(peer, msg)
            self._note_event(
                peer,
                "send-delta" if delta is not None else "send-full",
                epoch=self.epoch,
                bytes_=wire,
            )
            if link.dark:
                link.probe_attempt += 1
                link.next_probe_round = self.epoch + _backoff_rounds(
                    link.probe_attempt, self.backoff_limit
                )
            self._track_flight(link, wire)

    def _track_flight(self, link: _LinkState, wire: int) -> None:
        """Keep ONE long-lived flight record per link covering the
        newest un-acked epoch, so a partitioned link shows up as an
        aging in-flight record whose op NAMES the region
        (``region_delta:<src>-><dst>``) — what ``diff_flight_rings``
        reports. Opened via ``FLIGHT.open`` so the record is TRACKED:
        exempt from the watchdog's collective deadline and from the
        cross-rank lockstep diff (module docstring)."""
        if not _FLIGHT.enabled:
            return
        if link.flight is not None and link.flight.in_flight:
            link.flight.payload_bytes = wire
            _FLIGHT.issued(link.flight)
        else:
            link.flight = _FLIGHT.open(
                f"region_delta:{self.my_region.name}->{link.name}",
                payload_bytes=wire,
                rank=self._group.rank,
                world_size=len(self.regions),
            )
        link.flight_epoch = self.epoch

    def _drain_incoming(self) -> None:
        blobs = self.transport.poll(self.my_region.name)
        for blob in blobs:
            try:
                msg = pickle.loads(blob)
            except Exception:  # noqa: BLE001 — a torn message is a lost one
                continue
            if not isinstance(msg, dict):
                continue  # foreign traffic on a shared transport namespace
            try:
                self._process_message(msg)
            except Exception as e:  # noqa: BLE001 — one bad message must
                # not poison the drain; count it like a corrupt payload
                src = msg.get("src")
                link = self._links.get(src)
                if link is not None:
                    link.health.crc_failures += 1
                warnings.warn(
                    f"dropping malformed inter-region message from "
                    f"{src!r}: {type(e).__name__}: {e}",
                    RuntimeWarning,
                )

    def _process_message(self, msg: Dict[str, Any]) -> None:
        src = msg.get("src")
        link = self._links.get(src)
        if link is None or msg.get("dst") != self.my_region.name:
            return  # misrouted (chaos duplicates can cross-deliver)
        kind = msg.get("kind")
        if kind == "ack":
            self._note_ack(link, int(msg.get("epoch", 0)))
            return
        if kind == "resync":
            # the peer lost our base: ship a full snapshot next round
            link.force_full = True
            link.health.resyncs += 1
            self._note_event(src, "resync", epoch=int(msg.get("have", 0)))
            return
        if kind not in ("full", "delta"):
            return
        # piggybacked ack rides every snapshot message
        self._note_ack(link, int(msg.get("ack", 0)), piggyback=True)
        epoch = int(msg["epoch"])
        if epoch <= link.merged_epoch:
            # the epoch-ledger idempotency: re-delivered / out-of-date
            # epochs are discarded; re-ack so the sender's view converges
            link.health.duplicates += 1
            self._note_event(src, "duplicate", epoch=epoch)
            self._post(
                src,
                {"kind": "ack", "src": self.my_region.name, "dst": src,
                 "epoch": link.merged_epoch},
            )
            return
        if kind == "delta":
            base = int(msg["base"])
            if base != link.merged_epoch or link.merged_buf is None:
                # out-of-order beyond the ledger's base: drop and ask for
                # anti-entropy (ONE cumulative full next round)
                link.health.resyncs += 1
                self._note_event(src, "base-mismatch", epoch=epoch)
                self._post(
                    src,
                    {"kind": "resync", "src": self.my_region.name,
                     "dst": src, "have": link.merged_epoch},
                )
                return
            buf = apply_delta(link.merged_buf, msg["delta"])
        else:
            buf = np.asarray(msg["buf"], dtype=np.uint8)
        from torcheval_tpu_torch.metrics import synclib

        meta = msg["meta"]
        if synclib.canonical_crc(meta[0], meta[1], buf) != int(msg["crc"]):
            # a corrupt (or wrongly-based) payload must never merge; the
            # check runs on the POST-DEQUANTIZE canonical bytes (what
            # this region will actually merge — see _post_updates); the
            # sender will ship a full once it sees our stale ack
            link.health.crc_failures += 1
            self._note_event(src, "crc-failure", epoch=epoch)
            self._post(
                src,
                {"kind": "resync", "src": self.my_region.name, "dst": src,
                 "have": link.merged_epoch},
            )
            return
        healed = link.dark
        link.merged_epoch = epoch
        link.merged_meta = msg["meta"]
        link.merged_buf = buf
        link.merged_at_round = self.epoch
        link.merged_wall = time.time()
        link.health.merges += 1
        if healed:
            link.dark = False
            link.probe_attempt = 0
            link.next_probe_round = 0
            link.health.heals += 1
            self._note_event(src, "heal", epoch=epoch)
        self._note_event(src, "merge", epoch=epoch, bytes_=int(buf.nbytes))
        self._post(
            src,
            {"kind": "ack", "src": self.my_region.name, "dst": src,
             "epoch": epoch},
        )

    def _note_ack(
        self, link: _LinkState, epoch: int, piggyback: bool = False
    ) -> None:
        if epoch <= 0:
            return
        link.health.acks_seen += 1
        if epoch > link.acked:
            link.acked = epoch
            link.force_full = False
        link.probe_attempt = 0
        if not piggyback:
            self._note_event(link.name, "ack", epoch=epoch)
        if (
            link.flight is not None
            and link.flight.in_flight
            and epoch >= link.flight_epoch
        ):
            _FLIGHT.close(
                link.flight,
                ranks=tuple(range(len(self.regions))),
                detail=f"acked epoch {epoch}",
            )
            link.flight = None

    def _refresh_dark_flags(self) -> None:
        for link in self._links.values():
            stale = self.epoch - link.merged_at_round
            if not link.dark and stale > self.partition_after:
                link.dark = True
                link.probe_attempt = 0
                link.next_probe_round = self.epoch + 1
                link.health.partitions += 1
                self._note_event(
                    link.name, "partition", epoch=link.merged_epoch,
                    staleness=stale,
                )
                self._alert_staleness(link.name, stale)
                if link.flight is not None and link.flight.in_flight:
                    _FLIGHT.close(
                        link.flight,
                        failed=True,
                        detail=(
                            f"partitioned: {stale} rounds without a merge "
                            f"from {link.name}"
                        ),
                    )
                    link.flight = None

    def _alert_staleness(self, region: str, staleness: int) -> None:
        """The staleness alert (recorder-gated ``AlertEvent``) emitted
        when a region crosses the partition bound — the acceptance
        criterion's "staleness alert while partitioned"."""
        if not _OBS.enabled:
            return
        from torcheval_tpu_torch.obs.events import AlertEvent

        _OBS.record(
            AlertEvent(
                rank=self._group.rank,
                name=f"federation/{region}",
                alert="region-staleness",
                value=float(staleness),
                bound=float(self.partition_after),
                message=(
                    f"region {region} has not merged for {staleness} "
                    f"exchange rounds (partition_after="
                    f"{self.partition_after}); federating the surviving "
                    "regions"
                ),
            )
        )

    def _note_event(
        self,
        peer: str,
        action: str,
        *,
        epoch: int = 0,
        bytes_: int = 0,
        staleness: int = 0,
    ) -> None:
        if not _OBS.enabled:
            return
        from torcheval_tpu_torch.obs.events import RegionSyncEvent

        link = self._links.get(peer)
        _OBS.record(
            RegionSyncEvent(
                rank=self._group.rank,
                region=self.my_region.name if self.my_region else "",
                peer=peer,
                action=action,
                epoch=epoch,
                local_epoch=self.epoch,
                peer_epoch=link.merged_epoch if link else 0,
                nbytes=bytes_,
                staleness_epochs=staleness,
            )
        )

    # ------------------------------------------------- intra-region broadcast

    def _ledger_view(self) -> Dict[str, Any]:
        """The leader's broadcast payload: light per-link stamps every
        round, the full snapshot buffer ONLY for links whose merged
        epoch advanced since the last broadcast — members already hold
        the unchanged buffers, and re-shipping a quiet link's full
        snapshot intra-region every round would pay full-state bytes
        for nothing (the WAN side went to delta lengths to avoid
        exactly that)."""
        view = {}
        for name, link in self._links.items():
            entry: Dict[str, Any] = {
                "merged_epoch": link.merged_epoch,
                "merged_at_round": link.merged_at_round,
                "merged_wall": link.merged_wall,
                "dark": link.dark,
            }
            if self._last_broadcast.get(name) != link.merged_epoch:
                entry["merged_meta"] = link.merged_meta
                entry["merged_buf"] = link.merged_buf
                self._last_broadcast[name] = link.merged_epoch
            view[name] = entry
        return view

    def _adopt_ledger_view(self, view: Dict[str, Any]) -> None:
        for name, entry in view.items():
            link = self._links.get(name)
            if link is None:
                continue
            link.merged_epoch = int(entry["merged_epoch"])
            link.merged_at_round = int(entry["merged_at_round"])
            link.merged_wall = float(entry["merged_wall"])
            link.dark = bool(entry["dark"])
            if "merged_buf" in entry:
                link.merged_meta = entry["merged_meta"]
                link.merged_buf = entry["merged_buf"]

    def _broadcast_ledger(self) -> None:
        """Leader -> region members: one subgroup allgather where only
        the leader's slot carries the remote ledger (the
        ``HierarchicalGroup`` level-3 shape) so every member federates
        the same snapshots. A single-member region skips the wire."""
        if self.region_group.world_size == 1:
            return
        payload = self._ledger_view() if self.is_leader else None
        shared = self.region_group.allgather_object(payload)
        if not self.is_leader:
            # leader is the region's lowest rank -> subgroup slot 0
            view = shared[0]
            if view is not None:
                self._adopt_ledger_view(view)

    # ------------------------------------------------------------ global read

    def federate(
        self,
        metrics: Union[Dict[str, Any], Any],
        *,
        on_failure: Optional[str] = None,
        plane: Optional[Any] = None,
    ) -> Dict[str, Any]:
        """One exchange round, then the bounded-staleness GLOBAL merge:
        every region's freshest snapshot (local region at this very
        epoch; remote regions at their last merged epoch) merged in
        region order through ``merge_state`` — the identical discipline
        the toolkit applies to ranks. Returns merged ``{name: Metric}``
        carrying ``federation_provenance`` (and the intra-region sync's
        ``sync_provenance``).

        Degradation mirrors quorum semantics: dark/absent regions are
        skipped and flagged (policy ``"quorum"``); ``"raise"`` raises
        :class:`RegionPartitionError`; and once any region is DARK,
        fewer contributing regions than the quorum fraction raises too.

        ``plane``: feed the exchange from a
        :class:`~torcheval_tpu_torch.syncplane.SyncPlane` instead of stalling
        for the intra-region sync (see :meth:`exchange`).
        """
        from torcheval_tpu_torch.metrics.metric import Metric

        single = isinstance(metrics, Metric)
        synced = self.exchange(metrics, on_failure=on_failure, plane=plane)
        if not self.is_member:
            return synced
        merged = self._merge_global(synced)
        return merged["_metric"] if single and "_metric" in merged else merged

    def sync_and_compute(
        self,
        metrics: Union[Dict[str, Any], Any],
        *,
        on_failure: Optional[str] = None,
        plane: Optional[Any] = None,
    ) -> Union[Dict[str, Any], Any]:
        """:meth:`federate`, then ``compute()`` on the merged result —
        the federated sibling of ``toolkit.sync_and_compute(_collection)``.
        Single metrics return the bare value; collections a
        ``{name: value}`` dict. ``self.last_provenance`` holds the
        staleness declaration of this read; ``plane``: see
        :meth:`exchange`."""
        from torcheval_tpu_torch.metrics.metric import Metric

        merged = self.federate(metrics, on_failure=on_failure, plane=plane)
        if isinstance(merged, Metric):
            return merged.compute()
        return {name: m.compute() for name, m in merged.items()}

    def _merge_global(self, synced: Dict[str, Any]) -> Dict[str, Any]:
        statuses = self.region_statuses()
        missing = [
            s for s in statuses if not s.is_self and (s.epoch == 0 or s.dark)
        ]
        if missing and self.policy == "raise":
            raise RegionPartitionError(
                f"regions {[s.name for s in missing]} are dark or have "
                f"never contributed (policy 'raise'); statuses: {statuses}"
            )
        contributing = [
            s for s in statuses if s.is_self or (s.epoch > 0 and not s.dark)
        ]
        # the quorum bound fires only once a region is DARK: a region
        # that has never contributed but is still inside the staleness
        # bound is a COLD START (first exchange rounds of any >2-region
        # federation), which degrades with provenance instead of failing
        # — staleness has not been exceeded, the snapshot just has not
        # arrived yet. policy="raise" above stays strict either way.
        needed = quorum_count(self.quorum, len(self.regions))
        if any(s.dark for s in statuses) and len(contributing) < needed:
            raise RegionPartitionError(
                f"federation quorum not met: {len(contributing)}/"
                f"{len(self.regions)} regions contributing, quorum requires "
                f">= {needed} (fraction {self.quorum})"
            )
        per_region: List[Dict[str, Dict[str, Any]]] = []
        merged_names: List[str] = []
        for s in statuses:
            if s.is_self:
                meta, buf = self._history[self.epoch]
                per_region.append(
                    self._unpack_region_snapshot(synced, meta, buf)
                )
                merged_names.append(s.name)
                continue
            if s.epoch == 0 or s.dark:
                continue
            link = self._links[s.name]
            per_region.append(
                self._unpack_region_snapshot(
                    synced, link.merged_meta, link.merged_buf
                )
            )
            merged_names.append(s.name)
        provenance = FederationProvenance(
            regions=statuses,
            merged_regions=tuple(merged_names),
            degraded=len(merged_names) < len(self.regions),
            policy=self.policy,
            epoch=self.epoch,
        )
        merged = merge_region_states(synced, per_region)
        for m in merged.values():
            m.federation_provenance = provenance
        self.last_provenance = provenance
        return merged

    # ---------------------------------------------------------- crash safety

    def ledger_payload(self) -> Dict[str, Any]:
        """The epoch ledger + snapshot history as a picklable payload —
        what rides elastic snapshot bundles
        (``elastic.ElasticSession(federation=...)``). Mergeability by
        epoch replacement makes the restore safe against any crash
        point: a re-delivered epoch is discarded, an un-acked delta is
        re-derived from the cumulative snapshot."""
        return {
            "schema": 1,
            "region": self.my_region.name if self.my_region else None,
            "regions": [(s.name, tuple(s.ranks)) for s in self.regions],
            "epoch": self.epoch,
            "history": {
                e: (meta, buf.tobytes())
                for e, (meta, buf) in self._history.items()
            },
            "links": {
                name: {
                    "merged_epoch": link.merged_epoch,
                    "merged_meta": link.merged_meta,
                    "merged_buf": (
                        None
                        if link.merged_buf is None
                        else link.merged_buf.tobytes()
                    ),
                    "merged_at_round": link.merged_at_round,
                    "merged_wall": link.merged_wall,
                    "acked": link.acked,
                    "dark": link.dark,
                }
                for name, link in self._links.items()
            },
        }

    def load_ledger(self, payload: Optional[Dict[str, Any]]) -> None:
        """Restore :meth:`ledger_payload`. Layout mismatches (different
        regions) start fresh instead of guessing — anti-entropy heals a
        fresh ledger with one full exchange per link. Every link is
        marked ``force_full`` (the conservative resync posture: the
        peers' acks may be ahead of what this crashed rank remembers)."""
        if not payload or not self.is_member:
            return
        if payload.get("schema") != 1 or [
            (s.name, tuple(s.ranks)) for s in self.regions
        ] != [(n, tuple(r)) for n, r in payload.get("regions", [])]:
            warnings.warn(
                "federation ledger layout mismatch; starting a fresh "
                "ledger (anti-entropy will re-converge via full snapshots)",
                RuntimeWarning,
            )
            return
        self.epoch = int(payload["epoch"])
        self._history = {
            int(e): (meta, np.frombuffer(raw, dtype=np.uint8).copy())
            for e, (meta, raw) in payload.get("history", {}).items()
        }
        for name, entry in payload.get("links", {}).items():
            link = self._links.get(name)
            if link is None:
                continue
            link.merged_epoch = int(entry["merged_epoch"])
            link.merged_meta = entry["merged_meta"]
            raw = entry["merged_buf"]
            link.merged_buf = (
                None
                if raw is None
                else np.frombuffer(raw, dtype=np.uint8).copy()
            )
            link.merged_at_round = int(entry["merged_at_round"])
            link.merged_wall = float(entry["merged_wall"])
            link.acked = int(entry["acked"])
            link.dark = bool(entry["dark"])
            link.force_full = True


# --------------------------------------------------------------------------
# Cross-region merge
# --------------------------------------------------------------------------


def _federation_clone(base):
    """A merge clone for cross-region payloads.

    Region snapshots are LOGICAL: the intra-region merge already
    reassembled sharded carriers / hash-partitioned tables into full
    logical states. Loading a logical payload into an ordinary sharded
    clone would RE-SLICE it to the clone's own shard
    (``Metric._adopt_shard_payload`` / the table's owned-key filter),
    silently dropping every foreign cell from the cross-region merge —
    so federation clones carry a WORLD-1 shard context instead: a
    world-1 "shard" of a logical state IS the whole logical state, the
    clone becomes a world-1 carrier, and the reassembling
    ``merge_state`` then folds the regions' logical states additively
    (full-range slices, empty outboxes) — exactly the already-logical
    fold ``Metric._merge_sharded`` / ``MetricTable.merge_state`` define.
    """
    from torcheval_tpu_torch.metrics.toolkit import clone_metric

    clone = clone_metric(base)
    ctx = getattr(clone, "_shard_ctx", None)
    if ctx is not None and not ctx.is_mesh:
        from torcheval_tpu_torch.metrics.shardspec import ShardContext

        clone._shard_ctx = ShardContext(0, 1)
    if getattr(clone, "_hash_partitioned", False):
        clone.rank, clone.world = 0, 1
    return clone


def merge_region_states(
    template: Dict[str, Any],
    per_region_states: Sequence[Dict[str, Dict[str, Any]]],
) -> Dict[str, Any]:
    """Merge per-region LOGICAL snapshots into fresh metrics — the
    toolkit's gather-then-merge loop applied to regions instead of ranks
    (identical clone/load/merge-in-order discipline, so a federation of
    one region per rank merges bit-identically to the flat toolkit
    sync). Exposed for the exactly-once regression suite."""
    from torcheval_tpu_torch.metrics.toolkit import _restore_state_types

    merged: Dict[str, Any] = {}
    for name, base in template.items():
        region_metrics = []
        for states in per_region_states:
            clone = _federation_clone(base)
            clone.load_state_dict(
                _restore_state_types(dict(states[name])), strict=False
            )
            region_metrics.append(clone)
        target = region_metrics[0]
        if len(region_metrics) > 1:
            target.merge_state(region_metrics[1:])
        merged[name] = target
    return merged
