# tev: scope=host — the failure-domain controller is serving-thread host
# code by design: detection reads existing signals without a collective,
# and the recovery epoch runs on dedicated survivor subgroups.
"""Coordinated rank-loss recovery: detect → reconstruct → reform → rejoin.

Counterpart of ``torcheval_tpu/failover.py``.

Every resilience layer in this stack recovers ALONE:
:class:`~torcheval_tpu_torch.resilience.ResilientGroup` re-forms its eager
communicator, :class:`~torcheval_tpu_torch.elastic.ElasticSession` redistributes
state across a process restart, :class:`~torcheval_tpu_torch.federation.Federation`
heals regions but assumes its leader survives, and a dead rank leaves the
:class:`~torcheval_tpu_torch.syncplane.SyncPlane` communicator,
:class:`~torcheval_tpu_torch.table.MetricTable` hash ownership and
``ShardSpec`` shards pointing at a corpse until an operator restarts the
job. :class:`FailureDomain` is the autopilot that coordinates them: one
controller per rank subscribes to the failure signals the stack already
emits (consecutive-missing sync streaks, watchdog stall trips, federation
dark-region probes) and, on confirmed loss, runs ONE recovery epoch:

1. **Reconstruct** — the dead rank's partitioned state is rebuilt on the
   survivors: hash-owned table slots and axis shards re-partition over
   the survivor world, folding in (a) every survivor's live shard, (b)
   the survivors' routed outbox entries addressed to the dead rank (they
   never left the survivors), and (c) the dead rank's own shard from the
   newest COMMITTED elastic generation. What cannot be rebuilt — the
   dead rank's live updates since that generation — is declared as a
   typed :class:`LossBound` stamped onto ``SyncProvenance.loss`` (zero
   when the kill lands on a generation boundary).
2. **Reform** — every communicator moves to the survivor world without a
   barrier: the serving group re-forms onto a survivors-only subgroup,
   the sync plane derives a fresh dedicated communicator
   (:meth:`~torcheval_tpu_torch.syncplane.SyncPlane.reform`), federation
   membership drops the dead ranks with leader failover to the lowest
   surviving rank (:meth:`~torcheval_tpu_torch.federation.Federation.reform`;
   the epoch ledger's existing ``resync`` anti-entropy rebuilds the new
   leader's delta bases — no new protocol), and armed admission budgets
   rescale to the survivor world
   (:meth:`~torcheval_tpu_torch.table.AdmissionController.rescale_world`).
3. **Live rejoin** — a recovered rank re-enters WITHOUT a process
   restart: every rank (revived included) adopts the survivors' merged
   snapshot through the elastic world-change reassembly path run
   in-memory (merge every carrier → one logical state → re-slice to the
   full world), bit-identical to an on-disk world-change resume.

The domain emits typed :class:`~torcheval_tpu_torch.obs.events.FailoverEvent`
records (``detected`` / ``reconstructed`` / ``reformed`` / ``rejoined``),
registers the ``resilience`` counter source, and ``/healthz`` reports a
NON-FAILING ``degraded-world`` status while the world is shrunk — a
degraded world still serves, with honest loss provenance.

Design constraints:

- detection issues ZERO collectives — it only reads local signals;
- the recovery epoch's collectives run on survivor-only subgroups,
  never on the serving update path. Survivors build those inside
  ``distributed.members_only()``: over processes that is a store-backed
  ``KVSubgroup``, which the dead take no part in (a
  ``torch.distributed.new_group`` would wait for every process);
- reconstruction and rejoin reuse the elastic merge/reshard machinery
  (``Metric.merge_state`` + logical ``load_state_dict``), so their
  results are bit-identical to the world-change restore oracle. Payloads
  cross the survivor gathers as numpy (``utils.convert.numpy_state_dict``),
  and the rebuilt state loads into the live metrics, in place where its
  shape is unchanged under donation, so graphs writing those tensors
  survive the recovery.
"""

from __future__ import annotations

import threading
import time
from typing import (
    Any,
    Callable,
    Dict,
    List,
    NamedTuple,
    Optional,
    Sequence,
    Tuple,
)

import numpy as np

from torcheval_tpu_torch import config
from torcheval_tpu_torch.distributed import ProcessGroup, members_only
from torcheval_tpu_torch.metrics.metric import Metric
from torcheval_tpu_torch.obs.recorder import RECORDER as _OBS
from torcheval_tpu_torch.resilience import SyncHealth
from torcheval_tpu_torch.utils.convert import load_numpy_state_dict, numpy_state_dict

__all__ = [
    "FailureDomain",
    "LossBound",
    "current_domain",
]

# controller states, in lifecycle order (numeric codes are the
# grammar-pinned `resilience` gauge values)
STATES: Tuple[str, ...] = ("armed", "degraded", "recovered")
_STATE_CODES = {name: i for i, name in enumerate(STATES)}


class LossBound(NamedTuple):
    """Typed declaration of what a recovery could NOT rebuild.

    Stamped onto every reconstructed metric's ``sync_provenance.loss``
    (and re-stamped by :meth:`FailureDomain.stamp` after later drains),
    so every downstream ``compute()`` carries honest loss provenance.

    ``steps``/``epochs`` bound the dead ranks' unrecoverable updates:
    serving steps since the committed ``generation`` the reconstruction
    rebuilt from, and table drain epochs since that generation's commit.
    ``generation == -1`` means no committed generation existed — the
    dead ranks' entire owned history is gone. A kill landing exactly on
    a generation boundary (nothing ingested since the commit) loses
    nothing: ``steps == epochs == 0`` and :attr:`exact` is True.
    """

    ranks: Tuple[int, ...] = ()
    steps: int = 0
    epochs: int = 0
    generation: int = -1

    @property
    def exact(self) -> bool:
        """True when the reconstruction lost nothing (kill on a
        committed generation boundary)."""
        return self.generation >= 0 and self.steps == 0 and self.epochs == 0


def _sharded(metric: Metric) -> bool:
    """Partition-carrying metrics — the ones a rank loss actually
    truncates (mirrors ``toolkit._adoptable``). Replicated metrics lose
    nothing: every survivor holds the full state."""
    return bool(getattr(metric, "_sharded_states", None)) or bool(
        getattr(metric, "_hash_partitioned", False)
    )


def _rebind(metric: Metric, rank: int, world: int) -> None:
    """Point one metric's partitioning config at a new (rank, world) —
    the in-memory twin of constructing it in that world. Routing kernels
    re-derive from the new shard ranges (the kernel cache is keyed by
    range); hash ownership reads the table's ``rank``/``world`` attrs."""
    from torcheval_tpu_torch.metrics.shardspec import ShardContext

    if getattr(metric, "_shard_ctx", None) is not None:
        metric._shard_ctx = ShardContext(rank, world)
    if getattr(metric, "_hash_partitioned", False):
        metric.rank = int(rank)
        metric.world = int(world)


class FailureDomain:
    """One rank's view of the coordinated rank-loss autopilot.

    Construct one per rank over that rank's live serving collection and
    its serving group; optionally hand it the rank's
    :class:`~torcheval_tpu_torch.elastic.ElasticSession` (reconstruction
    source + step cursor), :class:`~torcheval_tpu_torch.syncplane.SyncPlane`
    and :class:`~torcheval_tpu_torch.federation.Federation` so the reform
    phase carries them to the survivor world.

    Args:
        metrics: this rank's live ``{name: Metric}`` serving collection.
        group: the FULL-world serving group (a
            :class:`~torcheval_tpu_torch.resilience.ResilientGroup` or any
            ``ProcessGroup``). The domain derives survivor subgroups
            from it; it never mutates it.
        session: elastic session whose newest committed generation
            seeds dead-shard reconstruction (``None`` = nothing
            committed — the loss bound covers the dead ranks' entire
            history).
        plane: background sync plane to reform alongside the world.
        federation: federation to reform (leader failover included).
        health: the :class:`~torcheval_tpu_torch.resilience.SyncHealth`
            detection reads. Defaults to ``group.health`` for resilient
            groups, else the process default.
        detect_after: consecutive missing-rank syncs before a loss is
            confirmed (default ``config.failover_detect_after()``).
        step_of: serving-step cursor supplier for the loss bound
            (defaults to the session's step cursor; 0 without one).
    """

    def __init__(
        self,
        metrics: Dict[str, Metric],
        group: ProcessGroup,
        *,
        session: Optional[Any] = None,
        plane: Optional[Any] = None,
        federation: Optional[Any] = None,
        health: Optional[SyncHealth] = None,
        detect_after: Optional[int] = None,
        step_of: Optional[Callable[[], int]] = None,
    ) -> None:
        if not metrics or not all(
            isinstance(m, Metric) for m in metrics.values()
        ):
            raise TypeError(
                "metrics must be a non-empty {name: Metric} dict holding "
                "this rank's live serving collection"
            )
        if not group.is_member:
            raise ValueError(
                "this process is not a member of the given serving group"
            )
        self.metrics: Dict[str, Metric] = dict(metrics)
        self._base = group
        self.group: ProcessGroup = group
        self.world = int(group.world_size)
        self.rank = int(group.rank)
        self.session = session
        self.plane = plane
        self.federation = federation
        if health is None:
            health = getattr(group, "health", None)
        if health is None:
            from torcheval_tpu_torch.resilience import default_sync_health

            health = default_sync_health()
        self.health = health
        self.detect_after = (
            config.failover_detect_after()
            if detect_after is None
            else int(detect_after)
        )
        if self.detect_after < 1:
            raise ValueError(
                f"detect_after must be >= 1 sync, got {self.detect_after}"
            )
        self._step_of = step_of
        self.state = "armed"
        self.survivors: Tuple[int, ...] = tuple(range(self.world))
        self.dead_ranks: Tuple[int, ...] = ()
        self.loss: Optional[LossBound] = None
        self.detections = 0
        self.recoveries = 0
        self.rejoins = 0
        self._closed = False
        self._arm()

    # ------------------------------------------------------------- detection

    def poll(self) -> Tuple[int, ...]:
        """One detection pass — LOCAL signal reads only, zero collectives
        (safe on the serving update path every step).

        Confirms a loss when the sync layer has missed the SAME ranks
        for ``detect_after`` consecutive syncs, escalating immediately
        when the stall watchdog has tripped alongside a missing streak
        (a stall is hard evidence, not a transient), or when federation
        dark-region probes condemn a whole remote region. Returns the
        confirmed dead ranks (empty while the world is whole)."""
        if self.state != "armed":
            return self.dead_ranks
        with self.health._lock:
            missing = tuple(self.health.consecutive_missing)
            streak = int(self.health.consecutive_missing_count)
        threshold = self.detect_after
        if missing:
            from torcheval_tpu_torch.obs.watchdog import current_watchdog

            wd = current_watchdog()
            if wd is not None and wd.tripped:
                threshold = 1
        dead: Tuple[int, ...] = ()
        if missing and streak >= threshold:
            dead = missing
        dark = self._dark_region_ranks()
        if dark:
            dead = tuple(sorted(set(dead) | set(dark)))
        if dead:
            self._confirm(dead)
        return self.dead_ranks

    def note_failure(self, dead_ranks: Sequence[int]) -> Tuple[int, ...]:
        """Explicit confirmation path for callers that caught a
        partial-gather/timeout themselves (``raise``-policy drains): the
        surviving ranks observed the same survivor set (the
        ``PartialGatherError`` contract), so every survivor confirms the
        same dead set."""
        if self.state == "armed" and dead_ranks:
            self._confirm(tuple(sorted(int(r) for r in dead_ranks)))
        return self.dead_ranks

    def _dark_region_ranks(self) -> Tuple[int, ...]:
        """Ranks of federation regions condemned DARK by the existing
        probe machinery — a whole-region loss signal the sync streak
        cannot see (remote regions never join this rank's syncs)."""
        fed = self.federation
        if fed is None or not getattr(fed, "is_member", False):
            return ()
        dead: List[int] = []
        for spec in fed.regions:
            link = fed._links.get(spec.name)
            if link is not None and link.dark:
                dead.extend(spec.ranks)
        return tuple(sorted(set(dead) & set(self.survivors)))

    def _confirm(self, dead: Tuple[int, ...]) -> None:
        dead = tuple(r for r in dead if r in self.survivors)
        if not dead or self.rank in dead:
            # a rank cannot condemn itself; the survivors will
            return
        self.dead_ranks = dead
        self.state = "degraded"
        self.detections += 1
        self._emit("detected", dead_ranks=dead)

    # -------------------------------------------------------------- recovery

    def recover(self) -> LossBound:
        """Run the coordinated recovery epoch on this survivor
        (every survivor calls this at the same point — the confirmed
        dead set is identical rank-wide, so the sequence is lockstep).

        Reconstructs the dead ranks' partitioned state over the survivor
        world, then reforms every communicator. Returns the typed
        :class:`LossBound`; the domain stays ``recovered`` (serving on
        the survivor world) until :meth:`rejoin`."""
        if self.state != "degraded":
            raise RuntimeError(
                f"recover() requires a confirmed loss (state is "
                f"{self.state!r}); call poll()/note_failure() first"
            )
        dead = self.dead_ranks
        survivors = tuple(r for r in self.survivors if r not in dead)
        if len(survivors) < 1 or self.rank not in survivors:
            raise RuntimeError(
                f"rank {self.rank} is not among survivors {survivors}"
            )
        t0 = time.monotonic()
        loss = self._reconstruct(survivors, dead)
        self._reform(survivors)
        self.survivors = survivors
        self.loss = loss
        self.state = "recovered"
        self.recoveries += 1
        self._emit(
            "reformed",
            dead_ranks=dead,
            survivors=survivors,
            generation=loss.generation,
            loss_steps=loss.steps,
            loss_epochs=loss.epochs,
            seconds=time.monotonic() - t0,
        )
        return loss

    def _reconstruct(
        self, survivors: Tuple[int, ...], dead: Tuple[int, ...]
    ) -> LossBound:
        """Phase (a): rebuild the dead ranks' partitioned state.

        One object allgather on a survivors-only subgroup ships every
        survivor's live payloads; each survivor then loads the dead
        ranks' newest committed shards from the shared snapshot
        directory (same bytes everywhere — deterministic), merges ALL
        carriers into one logical state in carried-rank order (the
        elastic world-change reassembly, in memory) and re-slices to its
        survivor-world shard. Survivor outbox entries addressed to the
        dead ranks fold in during the merge — they never left the
        survivors."""
        from torcheval_tpu_torch.elastic import _from_plain
        from torcheval_tpu_torch.metrics.toolkit import (
            _restore_state_types,
            clone_metric,
        )

        t0 = time.monotonic()
        sub = self._subgroup(survivors)
        shared = [
            name for name, m in self.metrics.items() if _sharded(m)
        ]
        payloads = sub.allgather_object(
            {name: numpy_state_dict(self.metrics[name]) for name in shared}
        )
        generation, gen_step, dead_shards = self._dead_generation(dead)
        new_world = len(survivors)
        new_rank = survivors.index(self.rank)
        # drain epochs the dead ranks served after the generation commit:
        # those merges folded survivors' routed entries into state that
        # died with them (the loss) — and delivered the dead shards'
        # generation-time outboxes to the survivors, so folding those
        # again would double count. Epoch lag gates both.
        loss_epochs = 0
        for name in shared:
            live = self.metrics[name]
            if not getattr(live, "_hash_partitioned", False):
                continue
            for tree in dead_shards:
                state = tree["metrics"].get(name)
                if state is not None and "epoch" in state:
                    lag = int(live.epoch) - int(np.asarray(state["epoch"]))
                    loss_epochs = max(loss_epochs, lag)
        drained_since = loss_epochs > 0
        for name in shared:
            live = self.metrics[name]
            carriers = []
            for payload in payloads:
                peer = clone_metric(live)
                peer.reset()
                load_numpy_state_dict(peer, payload[name])
                carriers.append(peer)
            for tree in dead_shards:
                state = tree["metrics"].get(name)
                if state is None:
                    continue
                state = _restore_state_types(_from_plain(dict(state)))
                if drained_since and "out_h" in state:
                    # table outbox already delivered at a post-generation
                    # drain — empty it (owned slots stay: hash ownership
                    # kept them on the dead rank, never on survivors)
                    state["out_h"] = 0
                    state.pop("out_bounds", None)
                peer = clone_metric(live)
                peer.reset()
                peer.load_state_dict(state)
                if drained_since and getattr(peer, "_sharded_states", None):
                    # routed axis outboxes likewise already applied to
                    # the survivors' slices at those drains
                    peer._clear_outboxes()
                carriers.append(peer)
            logical = carriers[0].merge_state(carriers[1:])
            _rebind(live, new_rank, new_world)
            live.reset()
            live.load_state_dict(logical.state_dict())
        steps = max(0, self._cursor() - gen_step) if generation >= 0 else (
            self._cursor()
        )
        loss = LossBound(
            ranks=dead,
            steps=int(steps),
            epochs=int(loss_epochs) if generation >= 0 else self._max_epoch(),
            generation=int(generation),
        )
        self.stamp(self.metrics, loss)
        self._emit(
            "reconstructed",
            dead_ranks=dead,
            survivors=survivors,
            generation=loss.generation,
            loss_steps=loss.steps,
            loss_epochs=loss.epochs,
            seconds=time.monotonic() - t0,
        )
        return loss

    def _dead_generation(
        self, dead: Tuple[int, ...]
    ) -> Tuple[int, int, List[Dict[str, Any]]]:
        """The newest committed elastic generation's shards for the dead
        ranks: ``(generation, committed_step, [shard trees])``. A
        generation written at a different world size cannot contribute
        carriers (its shard ranges describe the wrong partitioning);
        ``(-1, 0, [])`` when nothing usable is committed."""
        from torcheval_tpu_torch.elastic import (
            load_shard_states,
            newest_committed_generation,
        )

        if self.session is None:
            return -1, 0, []
        newest = newest_committed_generation(self.session.directory)
        if newest is None:
            return -1, 0, []
        generation, gen_dir = newest
        trees: List[Dict[str, Any]] = []
        gen_step = 0
        for rank in dead:
            try:
                manifest, tree = load_shard_states(gen_dir, rank)
            except Exception:  # noqa: BLE001 — torn shard ≡ no shard
                continue
            if int(manifest["world_size"]) != self.world:
                return -1, 0, []
            gen_step = int(manifest["step"])
            trees.append(tree)
        if not trees:
            return -1, 0, []
        return generation, gen_step, trees

    def _reform(self, survivors: Tuple[int, ...]) -> None:
        """Phase (b): move every communicator to the survivor world.
        Barrier-free by construction — each piece is a local rebind plus
        at most a subgroup derivation (survivor-side bookkeeping; the
        first collective on each new communicator is its rendezvous)."""
        old_world = len(self.survivors)
        self.group = self._subgroup(survivors)
        if self.plane is not None:
            self.plane.reform(self.group)
        if self.federation is not None:
            self.federation.reform(survivors, self.group)
        for m in self.metrics.values():
            ctrl = getattr(m, "_admission", None)
            if ctrl is not None:
                ctrl.rescale_world(old_world, len(survivors))
        with self.health._lock:
            self.health.reforms += 1
            self.health.reformed_to = tuple(survivors)
            self.health.world_size = len(survivors)
            self.health.consecutive_missing = ()
            self.health.consecutive_missing_count = 0

    # --------------------------------------------------------------- rejoin

    def rejoin(
        self, dead_ranks: Optional[Sequence[int]] = None
    ) -> None:
        """Phase (c): live re-entry of the recovered rank(s) — EVERY
        original rank calls this (survivors and revived alike; the
        revived rank, which never confirmed its own death, passes the
        ``dead_ranks`` it was told). One full-world object allgather
        ships the survivors' carriers; every rank merges them to the
        logical state and re-slices to its full-world shard — the
        elastic world-change reassembly run in memory, bit-identical to
        an on-disk resume at the grown world. No process restarts."""
        from torcheval_tpu_torch.metrics.toolkit import clone_metric

        if dead_ranks is None:
            dead_ranks = self.dead_ranks
        dead = tuple(sorted(int(r) for r in dead_ranks))
        survivors = tuple(
            r for r in range(self.world) if r not in dead
        )
        t0 = time.monotonic()
        sub = self._subgroup(range(self.world))
        shared = [
            name for name, m in self.metrics.items() if _sharded(m)
        ]
        mine = (
            ({name: numpy_state_dict(self.metrics[name]) for name in shared},
             self.loss)
            if self.rank in survivors
            else (None, None)
        )
        gathered = sub.allgather_object(mine)
        payloads = [p for p, _ in gathered]
        for name in shared:
            live = self.metrics[name]
            carriers = []
            for rank, payload in enumerate(payloads):
                if rank in dead or payload is None:
                    continue
                peer = clone_metric(live)
                peer.reset()
                load_numpy_state_dict(peer, payload[name])
                carriers.append(peer)
            logical = carriers[0].merge_state(carriers[1:])
            _rebind(live, self.rank, self.world)
            live.reset()
            live.load_state_dict(logical.state_dict())
        if self.loss is None:
            # the revived rank never confirmed its own death — adopt the
            # survivors' declared bound alongside their state
            self.loss = next(
                (ls for _, ls in gathered if ls is not None), None
            )
        if self.loss is not None:
            self.stamp(self.metrics, self.loss)
        self.group = self._base
        if self.plane is not None:
            self.plane.reform(self.group)
        if self.federation is not None:
            self.federation.reform(tuple(range(self.world)), self.group)
        for m in self.metrics.values():
            ctrl = getattr(m, "_admission", None)
            if ctrl is not None:
                ctrl.rescale_world(len(survivors), self.world)
        with self.health._lock:
            self.health.reformed_to = ()
            self.health.world_size = self.world
        self.survivors = tuple(range(self.world))
        self.dead_ranks = ()
        self.state = "armed"
        self.rejoins += 1
        self._emit(
            "rejoined",
            dead_ranks=dead,
            survivors=self.survivors,
            seconds=time.monotonic() - t0,
        )

    # ------------------------------------------------------------ provenance

    def stamp(
        self, metrics: Dict[str, Metric], loss: Optional[LossBound] = None
    ) -> Dict[str, Metric]:
        """Stamp the incident's :class:`LossBound` onto each metric's
        ``sync_provenance.loss`` (later syncs rebuild provenance from
        scratch, so post-drain collections re-stamp through here — the
        loss is permanent: those updates are gone)."""
        from torcheval_tpu_torch.resilience import SyncProvenance

        if loss is None:
            loss = self.loss
        if loss is None:
            return metrics
        for m in metrics.values():
            prov = getattr(m, "sync_provenance", None)
            if prov is None:
                prov = SyncProvenance(
                    ranks=(self.rank,),
                    world_size=len(self.survivors),
                    degraded=bool(loss.ranks),
                    policy="quorum",
                )
            m.sync_provenance = prov._replace(loss=loss)
        return metrics

    def drain(self, on_failure: Optional[str] = None) -> Dict[str, Metric]:
        """Adopt-drain the collection on the CURRENT world's group and
        re-stamp loss provenance — the steady-state serving drain for a
        domain-managed collection (``toolkit.adopt_synced`` semantics)."""
        from torcheval_tpu_torch.metrics.toolkit import adopt_synced

        shared = {
            name: m for name, m in self.metrics.items() if _sharded(m)
        }
        synced = adopt_synced(shared, self.group, on_failure=on_failure)
        self.stamp(shared)
        self.stamp(synced)
        return synced

    # ------------------------------------------------------------- plumbing

    def _subgroup(self, ranks: Sequence[int]) -> ProcessGroup:
        """A survivors-only communicator derived from the base group
        (ranks are base-group-relative — the full-world numbering)."""
        ranks = tuple(int(r) for r in ranks)
        if ranks == tuple(range(self.world)):
            return self._base
        # ResilientGroup.new_subgroup returns a sibling carrying the same
        # retry/quorum knobs and health sink — recovery keeps them; only
        # the members build it, so the dead take no part
        with members_only():
            return self._base.new_subgroup(ranks)

    def _cursor(self) -> int:
        if self._step_of is not None:
            return int(self._step_of())
        if self.session is not None:
            return int(self.session.cursor)
        return 0

    def _max_epoch(self) -> int:
        epochs = [
            int(m.epoch)
            for m in self.metrics.values()
            if getattr(m, "_hash_partitioned", False)
        ]
        return max(epochs, default=0)

    def _emit(self, action: str, **fields: Any) -> None:
        if not _OBS.enabled:
            return
        from torcheval_tpu_torch.obs.events import FailoverEvent

        _OBS.record(
            FailoverEvent(
                rank=self.rank,
                action=action,
                world_size=len(self.survivors),
                **fields,
            )
        )

    # ------------------------------------------------------------ lifecycle

    def status(self) -> Dict[str, Any]:
        """The ``/healthz`` ``failover`` section (host-side reads only)."""
        out: Dict[str, Any] = {
            "armed": 1,
            "state": self.state,
            "dead_ranks": list(self.dead_ranks),
            "survivors": list(self.survivors),
            "world_size": self.world,
            "detections": self.detections,
            "recoveries": self.recoveries,
            "rejoins": self.rejoins,
        }
        if self.loss is not None:
            out["loss"] = {
                "ranks": list(self.loss.ranks),
                "steps": self.loss.steps,
                "epochs": self.loss.epochs,
                "generation": self.loss.generation,
                "exact": self.loss.exact,
            }
        return out

    def _counter_source(self) -> Dict[str, Any]:
        # numeric-only: every value renders as a Prometheus gauge
        # (the Prometheus exposition grammar)
        with self.health._lock:
            reformed = len(self.health.reformed_to)
            missing = len(self.health.consecutive_missing)
        loss = self.loss
        return {
            "armed": 1,
            "state": _STATE_CODES[self.state],
            "dead_ranks": len(self.dead_ranks),
            "survivor_world": len(self.survivors),
            "detections": self.detections,
            "recoveries": self.recoveries,
            "rejoins": self.rejoins,
            "reformed_to_size": reformed,
            "consecutive_missing": missing,
            "loss_steps": 0 if loss is None else loss.steps,
            "loss_epochs": 0 if loss is None else loss.epochs,
            "loss_exact": int(loss.exact) if loss is not None else 1,
        }

    def _arm(self) -> None:
        global _CURRENT
        with _CURRENT_LOCK:
            _CURRENT = self
        from torcheval_tpu_torch.obs.counters import default_registry

        default_registry().register("resilience", self._counter_source)

    def close(self) -> None:
        """Disarm: release the ``current_domain`` slot and unregister
        the counter source — only when still the armed one. Idempotent."""
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

            default_registry().unregister("resilience")

    def __enter__(self) -> "FailureDomain":
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> None:
        self.close()


_CURRENT: Optional[FailureDomain] = None  # tev: guarded-by=_CURRENT_LOCK
_CURRENT_LOCK = threading.Lock()


def current_domain() -> Optional[FailureDomain]:
    """The most recently armed, not-yet-closed failure domain (the
    ``/healthz`` ``degraded-world`` probe's handle), or ``None``."""
    return _CURRENT  # tev: disable=guarded-field -- single-reference read, atomic under the GIL; the healthz probe tolerates a one-scrape-stale domain
