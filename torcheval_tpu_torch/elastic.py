"""Elastic evaluation: preemption-safe snapshot/resume for metric state.

Counterpart of ``torcheval_tpu/elastic.py``: the same names, defaults,
messages, bundle layout and protocol. A preempted eval job used to lose
every accumulated metric state; an :class:`ElasticSession` keeps it.

- :class:`ElasticSession` wraps an eval loop and periodically snapshots a
  **bundle** (metric collection + step cursor + an opaque user payload,
  e.g. data-iterator state) through a two-phase commit:

  1. every rank writes and fsyncs its own shard file
     (``gen-<n>/shard-<rank>.bin``, torn writes allowed);
  2. the leader (rank 0) gathers every shard's sha256 + state digest
     (``utils/checkpoint.py``'s canonical leaf digest) and commits the
     generation by atomically renaming ``MANIFEST.json`` into place.

  The manifest is the commit record: a generation without one (or whose
  shards fail their digests) is never loaded. An async background writer
  keeps serialization and fsync off the step path (a bounded queue gives
  backpressure; :meth:`ElasticSession.close` drains it).

- **Exactly-once resume**: :meth:`ElasticSession.restore` walks committed
  generations newest-first, falls back past any generation with a missing
  or corrupt shard (quarantining it), restores the step cursor so the
  resumed loop can :meth:`~ElasticSession.fence` out already-counted
  batches, and resumes at a different world size: the old ranks are
  split contiguously over the new ones, and each new rank rebuilds its
  state through ``merge_state()``, in old-rank order.

The shard blob is a pickle of the JAX package's plain tree (numpy leaves,
Python scalars, the empty-array encoding; ``utils/checkpoint.py``'s
``_to_plain``) and ``MANIFEST.json`` has the JAX package's keys, so a
bundle written by either package restores in the other.

What differs from the JAX design is mutability. A snapshot captures each
metric's ``state_dict()``, which clones the states on the caller's
stream; the states themselves keep changing in place under donation. The
synchronous writer copies the clones to the host on the caller's thread.
The async writer records a CUDA event after the clones, and its thread
waits on that event from a stream of its own before copying, so the copy
reads the clones and never a later update; the clones stay referenced
until their copy has finished. The clones are the snapshot's transient
device bytes: one copy of every state.

Assumptions: all ranks see one shared filesystem; snapshots use plain
full-participation collectives (one ``allgather_object`` of shard
digests a snapshot), so a snapshot during a degraded sync window fails
and is retried at the next interval. ``LocalReplicaGroup`` (one
controller holding per-replica metric lists) is not supported: give each
logical rank its own session, or snapshot the synced metric with
``utils.save_metric_state``.

Observability (``torcheval_tpu_torch.obs``): ``step_done`` keeps the
recorder's step cursor on the session's; a snapshot's two-phase commit is
one ``torcheval.snapshot`` span and a ``SnapshotEvent``, a restore a
``RestoreEvent``, each fed to the latency digests; the registry's
``snapshots`` tallies move whether or not the recorder is on.

Sharded metrics (``Metric(shard=...)``) restore at a new world size by
merging every old shard and re-slicing (``_restore_metrics``).

Riders: ``federation=`` puts the federation's epoch ledger
(``Federation.ledger_payload``, numpy and bytes) in each shard's
``"federation"`` slot, taken on the caller thread, and a same-world
restore loads it back; ``plane=`` takes each snapshot under the sync
plane's ``quiesce()`` (no round in flight) and a restore invalidates the
plane's snapshots.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import pickle
import queue
import re
import shutil
import threading
import time
import warnings
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple, Union

import torch

from torcheval_tpu_torch.distributed import (
    LocalReplicaGroup,
    ProcessGroup,
    default_process_group,
)
from torcheval_tpu_torch.metrics.metric import Metric
from torcheval_tpu_torch.obs import counters as _obs_counters
from torcheval_tpu_torch.obs import hist as _obs_hist
from torcheval_tpu_torch.obs import trace as _obs_trace
from torcheval_tpu_torch.obs.events import RestoreEvent, SnapshotEvent
from torcheval_tpu_torch.obs.recorder import RECORDER as _OBS
from torcheval_tpu_torch.utils.checkpoint import (
    _digest,
    _from_plain,
    _to_plain,
    validate_state_dict,
)

__all__ = [
    "ElasticSession",
    "RestoreResult",
    "SCHEMA_VERSION",
    "load_shard_states",
    "newest_committed_generation",
]

SCHEMA_VERSION = 1

MANIFEST_NAME = "MANIFEST.json"
_GEN_RE = re.compile(r"^gen-(\d{8})$")

# the four crash points the two-phase commit exposes, in protocol order;
# utils.test_utils.SnapshotCrashPlan drives all of them deterministically
CRASH_POINTS = ("pre-shard", "mid-shard", "pre-manifest", "post-manifest")


def _cuda_tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _cuda_tensors(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _cuda_tensors(v)]
    if isinstance(tree, torch.Tensor) and tree.is_cuda:
        return [tree]
    return []


def _capture_event(states) -> Optional["torch.cuda.Event"]:
    """An event recorded on the caller's current stream after the
    ``state_dict()`` clones, when any of them lies on a card (``None``
    otherwise): the async writer waits on it before copying them."""
    tensors = _cuda_tensors(states)
    if not tensors:
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(tensors[0].device))
    return event


_COPY_STREAMS = threading.local()  # per writer thread: device index -> stream


def _copy_stream(device: torch.device) -> "torch.cuda.Stream":
    streams = _COPY_STREAMS.__dict__.setdefault("by_device", {})
    if device.index not in streams:
        streams[device.index] = torch.cuda.Stream(device)
    return streams[device.index]


def _to_host(tree, event: Optional["torch.cuda.Event"]):
    """The captured ``state_dict`` tree with its CUDA tensors copied to
    the host, ordered after ``event`` on a stream of the calling thread's
    own. ``record_stream`` marks each clone as used there, so the caching
    allocator cannot hand its memory out again before the copy is done."""
    if event is None:
        return tree

    def host(node):
        if isinstance(node, dict):
            return {k: host(v) for k, v in node.items()}
        if isinstance(node, list):
            return [host(v) for v in node]
        if isinstance(node, torch.Tensor) and node.is_cuda:
            stream = _copy_stream(node.device)
            with torch.cuda.stream(stream):
                stream.wait_event(event)
                node.record_stream(stream)
                return node.to("cpu")
        return node

    return host(tree)


class _BundleError(RuntimeError):
    """One generation is unusable (torn/corrupt/uncommitted) — restore
    falls back to the previous generation instead of surfacing this."""


class RestoreResult(NamedTuple):
    """What :meth:`ElasticSession.restore` recovered.

    ``step`` is the number of COMPLETED steps the snapshot covers — the
    loop must skip batches the fence rejects (``session.fence(step)``).
    ``world_size`` is the world that WROTE the snapshot;
    ``assigned_ranks`` names the old ranks whose shards this rank merged
    (contiguous, ascending), and ``payloads`` their opaque user payloads
    in the same order.
    """

    step: int
    generation: int
    world_size: int
    assigned_ranks: Tuple[int, ...]
    payloads: Tuple[Any, ...]

    @property
    def payload(self) -> Any:
        """The first assigned payload (THE payload on a same-world
        resume), or ``None`` when this rank was assigned no old shard."""
        return self.payloads[0] if self.payloads else None


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _assign_shards(old_world: int, new_world: int) -> List[Tuple[int, ...]]:
    """Contiguous ascending split of old ranks over new ranks: merging
    each new rank's slice locally and then merging across new ranks (in
    rank order, as the toolkit does) visits every old shard exactly once
    in old-rank order — the same order an uninterrupted merge would have
    used, so EXTEND concatenations stay bit-identical."""
    base, extra = divmod(old_world, new_world)
    out: List[Tuple[int, ...]] = []
    start = 0
    for r in range(new_world):
        n = base + (1 if r < extra else 0)
        out.append(tuple(range(start, start + n)))
        start += n
    return out


def newest_committed_generation(directory: str) -> Optional[Tuple[int, str]]:
    """The newest COMMITTED generation under an elastic snapshot
    directory as ``(generation, path)``, or ``None`` when nothing has
    committed. Commitment is the manifest's existence — the same atomic
    ``os.replace`` edge :meth:`ElasticSession.restore` trusts. A reader
    that holds no session can still locate recovery state this way."""
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return None
    newest: Optional[Tuple[int, str]] = None
    for name in names:
        m = _GEN_RE.match(name)
        if not m:
            continue
        path = os.path.join(directory, name)
        if not os.path.exists(os.path.join(path, MANIFEST_NAME)):
            continue
        if newest is None or int(m.group(1)) > newest[0]:
            newest = (int(m.group(1)), path)
    return newest


def _read_manifest(gen_dir: str) -> Dict[str, Any]:
    """The committed manifest of one generation, checked for its schema and
    one shard entry a rank."""
    try:
        with open(os.path.join(gen_dir, MANIFEST_NAME)) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise _BundleError(f"manifest unreadable: {e}")
    if manifest.get("schema") != SCHEMA_VERSION:
        raise _BundleError(
            f"unsupported schema {manifest.get('schema')!r} "
            f"(this build speaks {SCHEMA_VERSION})"
        )
    old_world = int(manifest.get("world_size", 0))
    entries = manifest.get("shards", [])
    if old_world < 1 or len(entries) != old_world:
        raise _BundleError(
            f"manifest lists {len(entries)} shards for world_size {old_world}"
        )
    return manifest


def _load_shard(gen_dir: str, manifest: Dict[str, Any], entry: Dict[str, Any]) -> Dict[str, Any]:
    """One shard's tree, after its byte length, sha256, pickle decode,
    state digest and step are checked against its manifest entry."""
    rank = int(entry["rank"])
    try:
        with open(os.path.join(gen_dir, ElasticSession._shard_name(rank)), "rb") as f:
            blob = f.read()
    except OSError as e:
        raise _BundleError(f"shard {rank} unreadable: {e}")
    if len(blob) != int(entry["bytes"]) or (
        hashlib.sha256(blob).hexdigest() != entry["sha256"]
    ):
        raise _BundleError(
            f"shard {rank} is torn or corrupt "
            f"({len(blob)} bytes vs manifest {entry['bytes']})"
        )
    try:
        tree = pickle.loads(blob)
    except Exception as e:  # noqa: BLE001 — torn pickle
        raise _BundleError(f"shard {rank} fails to decode: {e}")
    if _digest(_from_plain(tree["metrics"])) != entry["state_digest"]:
        raise _BundleError(f"shard {rank} fails its state digest")
    if int(tree.get("step", -1)) != int(manifest["step"]):
        raise _BundleError(
            f"shard {rank} records step {tree.get('step')} but the "
            f"manifest committed step {manifest['step']}"
        )
    return tree


def load_shard_states(
    gen_dir: str, rank: int
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Validate and load ONE rank's shard of a committed generation:
    ``(manifest, shard tree)`` with ``tree["metrics"]`` left in plain
    (JSON-safe) form. Runs the same checks restore applies per shard
    (schema, manifest/rank consistency, byte length + sha256, pickle
    decode, state digest, step agreement) but for a single rank, so a
    reader can pull one rank's shard without requiring the integrity of
    the others' files. Raises ``RuntimeError`` when the shard or manifest
    is unusable."""
    manifest = _read_manifest(gen_dir)
    entry = next((e for e in manifest["shards"] if int(e["rank"]) == int(rank)), None)
    if entry is None:
        raise _BundleError(f"manifest has no shard for rank {rank}")
    return manifest, _load_shard(gen_dir, manifest, entry)


class _SnapshotWriter:
    """Background bundle writer: a bounded queue + one daemon thread.

    ``submit`` BLOCKS when the queue is full (backpressure) rather than
    dropping: every rank must write the same generation sequence, and a
    rank silently skipping one would desynchronize the digest gather.
    Errors (including injected crashes) are ferried to the caller thread
    and re-raised at the next session call.
    """

    def __init__(self, write_bundle: Callable[..., None], depth: int = 2) -> None:
        self._write_bundle = write_bundle
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.error: Optional[BaseException] = None
        self._dead = False
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="torcheval-elastic-writer"
        )
        self._thread.start()

    def _loop(self) -> None:  # tev: scope=writer
        while True:
            job = self._q.get()
            try:
                if job is None:
                    return
                if self._dead:
                    continue  # a DEAD writer (process-death semantics)
                    # discards later queued generations — never
                    # half-commits after the simulated kill
                try:
                    self._write_bundle(*job)
                except Exception as e:  # noqa: BLE001 — ferried
                    # a RECOVERABLE per-generation error (ENOSPC, a
                    # failed collective): keep attempting later queued
                    # generations so this rank stays in collective
                    # lockstep with its peers — silently skipping would
                    # desynchronize the digest gathers rank-wide (a
                    # residual off-by-one still fails loudly at the
                    # leader's generation-consistency check)
                    if self.error is None:
                        self.error = e
                except BaseException as e:  # simulated/real process death
                    if self.error is None:
                        self.error = e
                    self._dead = True
            finally:
                self._q.task_done()

    def submit(self, job: tuple) -> None:
        self._q.put(job)

    def drain(self) -> None:
        self._q.join()

    def stop(self) -> None:
        self._q.put(None)
        self._thread.join(timeout=60.0)


class ElasticSession:
    """Preemption-safe snapshot/resume around a metric eval loop.

    Args:
        metrics: a ``{name: Metric}`` collection (or a single
            :class:`Metric`) holding this rank's local, unsynced states.
        directory: the bundle directory, shared by all ranks (one
            ``gen-<n>/`` subdirectory per snapshot generation).
        process_group: the rank world (default
            ``distributed.default_process_group()``). A
            ``resilience.ResilientGroup`` works; its degradation policies
            do not apply to snapshots: a snapshot either commits with
            full participation or fails.
        interval: snapshot every N completed steps (default
            ``config.snapshot_interval()``).
        retention: committed generations kept on disk (default
            ``config.snapshot_retention()``; older ones are rotated out
            by the leader after each commit).
        async_writer: move the host copy, serialization and fsync off the
            step path onto a background writer thread; the step path only
            clones the states (on the card, a device-to-device copy) and
            records an event (module docstring).
        fault_hook: test-only crash-point hook
            ``hook(point, generation=..., rank=...)`` called at each of
            :data:`CRASH_POINTS` (see
            ``utils.test_utils.SnapshotCrashPlan``).
        federation: a ``federation.Federation`` whose inter-region epoch
            ledger (merged remote snapshots, acked epochs, the snapshot
            history deltas diff against) rides every bundle. A same-world
            restore loads it back, so a crash mid-exchange neither
            double-counts a re-delivered epoch nor drops a delta; a
            world-size-change restore starts a fresh ledger with a
            warning (anti-entropy re-converges it).
        plane: a ``syncplane.SyncPlane`` over the same live metrics. A
            snapshot is taken under its ``quiesce()`` (no round in
            flight), and a restore calls its ``invalidate()``: the
            restored state replaces whatever any published or merged
            snapshot describes.

    Examples::

        >>> session = ElasticSession(metrics, "/ckpt/eval", interval=100)
        >>> restored = session.restore()       # None on a fresh start
        >>> with session:
        ...     for step, batch in enumerate(loader):
        ...         if not session.fence(step):
        ...             continue               # already counted pre-crash
        ...         update_collection(metrics, *batch)
        ...         session.step_done(step, payload=loader_state())
    """

    def __init__(
        self,
        metrics: Union[Metric, Dict[str, Metric]],
        directory: str,
        *,
        process_group: Optional[ProcessGroup] = None,
        interval: Optional[int] = None,
        retention: Optional[int] = None,
        async_writer: bool = False,
        fault_hook: Optional[Callable[..., None]] = None,
        federation: Optional[Any] = None,
        plane: Optional[Any] = None,
    ) -> None:
        from torcheval_tpu_torch import config

        if isinstance(metrics, Metric):
            metrics = {"_metric": metrics}
        if not metrics or not all(isinstance(m, Metric) for m in metrics.values()):
            raise TypeError(
                "metrics must be a Metric or a non-empty {name: Metric} "
                "dict holding this rank's metrics"
            )
        self.metrics: Dict[str, Metric] = dict(metrics)
        self.directory = os.path.abspath(os.fspath(directory))
        group = process_group if process_group is not None else default_process_group()
        if isinstance(group.unwrap(), LocalReplicaGroup):
            raise TypeError(
                "ElasticSession snapshots one rank's metrics per session; "
                "a LocalReplicaGroup's per-replica metric lists are not "
                "supported — run one session per logical rank, or "
                "checkpoint the synced metric with utils.save_metric_state"
            )
        if not group.is_member:
            raise ValueError("this process is not a member of the given process group")
        self._group = group
        self.interval = config.snapshot_interval() if interval is None else int(interval)
        if self.interval < 1:
            raise ValueError(f"interval must be >= 1, got {interval}")
        self.retention = (
            config.snapshot_retention() if retention is None else int(retention)
        )
        if self.retention < 1:
            raise ValueError(f"retention must be >= 1, got {retention}")
        self._fault_hook = fault_hook
        self._federation = federation
        self._plane = plane
        os.makedirs(self.directory, exist_ok=True)
        self._cursor = 0  # completed steps covered by current state
        self._since_snapshot = 0
        self._payload: Any = None  # latest user payload, rides next snapshot
        # next generation number, from the COMMITTED generations only: a
        # commit happens strictly after every rank's digest allgather, so
        # the committed set cannot change while one cohort's ranks are
        # constructing their sessions (counting uncommitted dirs would
        # race a fast rank's first shard write against a slow rank's
        # scan). An uncommitted leftover at the same number is overwritten
        # and re-committed.
        gens = [g for g, _ in self._committed_generations()]
        self._next_gen = (gens[-1] + 1) if gens else 0
        self.snapshots_written = 0
        self._writer = _SnapshotWriter(self._write_bundle) if async_writer else None
        # the communicator snapshot collectives run on. In async mode the
        # writer THREAD issues the digest allgather, which must not share
        # a collective sequence with main-thread metric syncs on the same
        # group (the two threads' collectives would pair off in different
        # orders on different ranks): async snapshots get a DEDICATED
        # whole-world subgroup with its own sequence.
        self._comm: ProcessGroup = group
        self._comm_ranks: Tuple[int, ...] = tuple(group.ranks)
        if async_writer:
            self._comm = self._dedicated_comm()
        self._closed = False

    def _dedicated_comm(self) -> ProcessGroup:
        try:
            return self._group.new_subgroup(range(self._group.world_size))
        except NotImplementedError:
            if self._group.world_size > 1:
                warnings.warn(
                    f"{type(self._group).__name__} cannot scope a dedicated "
                    "snapshot communicator (no new_subgroup): with "
                    "async_writer=True, do not issue metric-sync "
                    "collectives on this group while a snapshot may be in "
                    "flight — cross-thread collectives on one group can "
                    "pair off out of order across ranks",
                    RuntimeWarning,
                )
            return self._group

    def _refresh_comm(self) -> None:
        """Re-derive the dedicated communicator when the group's
        membership changed (a ResilientGroup re-formed onto survivors);
        called on the main thread, from ``snapshot()``."""
        if self._writer is None:
            self._comm = self._group
            return
        ranks = tuple(self._group.ranks)
        if ranks != self._comm_ranks:
            self._comm = self._dedicated_comm()
            self._comm_ranks = ranks

    # ------------------------------------------------------------- loop API

    @property
    def cursor(self) -> int:
        """Completed steps covered by the current metric state."""
        return self._cursor

    def fence(self, step: int) -> bool:
        """True when ``step`` (0-based) still needs processing; False when
        the restored snapshot already covers it: the exactly-once guard
        that keeps a resumed loop from double-counting a batch."""
        return int(step) >= self._cursor

    def step_done(self, step: Optional[int] = None, payload: Any = None) -> None:
        """Mark one step complete (advancing the cursor) and snapshot
        when the interval is due. ``step`` (optional, 0-based) must be the
        step the cursor expects: passing it catches loops that forgot to
        :meth:`fence`. A non-``None`` ``payload`` is retained and rides
        the next snapshot, replacing any previously retained payload."""
        self._check_open()
        self._raise_writer_error()
        if step is not None and int(step) != self._cursor:
            raise RuntimeError(
                f"out-of-order step_done({step}): the session cursor is at "
                f"{self._cursor} — gate the loop with session.fence(step) "
                "so already-counted batches are skipped exactly once"
            )
        if payload is not None:
            self._payload = payload
        self._cursor += 1
        self._since_snapshot += 1
        if _OBS.enabled:
            # the session IS the step authority in an elastic loop: keep
            # the recorder's step cursor in lockstep with it
            _OBS.set_step(self._cursor)
        if self._since_snapshot >= self.interval:
            self.snapshot()

    def snapshot(self, payload: Any = None) -> int:
        """Snapshot the current bundle now (all ranks must call in step:
        the commit gathers every rank's shard digest). A non-``None``
        ``payload`` replaces the retained one (see :meth:`step_done`).
        Returns the generation number (async mode: the generation that
        was queued)."""
        self._check_open()
        self._raise_writer_error()
        self._refresh_comm()
        if payload is not None:
            self._payload = payload
        generation = self._next_gen
        self._next_gen += 1
        self._since_snapshot = 0
        # clones on the caller's stream; the async writer copies them to
        # the host after the event (module docstring). The federation
        # ledger is taken here too, on the caller thread, and with a sync
        # plane no round is in flight while the bundle's view is taken
        quiesce = self._plane.quiesce() if self._plane is not None else contextlib.nullcontext()
        with quiesce:
            states = {name: m.state_dict() for name, m in self.metrics.items()}
            fed_payload = (
                self._federation.ledger_payload() if self._federation is not None else None
            )
        if self._writer is not None:
            event = _capture_event(states)
            self._writer.submit(
                (generation, states, self._cursor, self._payload, event, fed_payload)
            )
        else:
            self._write_bundle(
                generation, states, self._cursor, self._payload, fed_payload=fed_payload
            )
        return generation

    def drain(self) -> None:
        """Block until every queued async snapshot has been written."""
        if self._writer is not None:
            self._writer.drain()
        self._raise_writer_error()

    def close(self) -> None:
        """Drain and stop the async writer; re-raise any writer error."""
        if self._closed:
            return
        self._closed = True
        if self._writer is not None:
            self._writer.drain()
            self._writer.stop()
        self._raise_writer_error()

    def __enter__(self) -> "ElasticSession":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            # the body is already unwinding: drain best-effort, but do not
            # mask the primary error with a writer error
            try:
                self.close()
            except BaseException:  # noqa: BLE001
                pass
        else:
            self.close()

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("ElasticSession is closed")

    def _raise_writer_error(self) -> None:
        if self._writer is not None and self._writer.error is not None:
            error, self._writer.error = self._writer.error, None
            raise error

    # ------------------------------------------------------ snapshot (write)

    def _fault(self, point: str, generation: int) -> None:
        if self._fault_hook is not None:
            self._fault_hook(point, generation=generation, rank=self._group.rank)

    def _generation_dir(self, generation: int) -> str:
        return os.path.join(self.directory, f"gen-{generation:08d}")

    @staticmethod
    def _shard_name(rank: int) -> str:
        return f"shard-{rank:05d}.bin"

    def _write_bundle(
        self,
        generation: int,
        metric_states: Dict[str, Dict[str, Any]],
        cursor: int,
        payload: Any,
        event: Optional["torch.cuda.Event"] = None,
        fed_payload: Optional[Dict[str, Any]] = None,
    ) -> int:
        """Two-phase commit of one generation (see module docstring);
        returns this rank's shard size in bytes.

        Runs on the caller thread (sync mode) or the background writer
        (async mode); all collectives go through ``self._comm``, in async
        mode a dedicated whole-world subgroup whose collective sequence
        nothing else shares.
        """
        write_t0 = time.monotonic()
        # the whole commit is one span (the digest gather parents to it);
        # recorder off = no frame, nothing to pay
        with _obs_trace.scope_or_null("torcheval.snapshot", _OBS.enabled) as snap_frame:
            shard_bytes = self._write_bundle_body(
                generation, metric_states, cursor, payload, event, fed_payload
            )
        seconds = time.monotonic() - write_t0
        # registry tallies accumulate whether or not event recording is on
        # (snapshotting is off the hot path); the typed event is gated
        _obs_counters.note_snapshot(generation, seconds)
        if _OBS.enabled and snap_frame is not None:
            _obs_hist.observe("snapshot", seconds)
            _OBS.record(
                SnapshotEvent(
                    rank=self._comm.rank,
                    step=int(cursor),
                    generation=generation,
                    seconds=seconds,
                    shard_bytes=shard_bytes,
                    async_writer=self._writer is not None,
                    trace=snap_frame.trace_id,
                    span=snap_frame.span_id,
                    parent=snap_frame.parent_id,
                )
            )
        return shard_bytes

    def _write_bundle_body(
        self,
        generation: int,
        metric_states: Dict[str, Dict[str, Any]],
        cursor: int,
        payload: Any,
        event: Optional["torch.cuda.Event"],
        fed_payload: Optional[Dict[str, Any]],
    ) -> int:
        group = self._comm
        rank, world = group.rank, group.world_size
        self._fault("pre-shard", generation)
        gen_dir = self._generation_dir(generation)
        os.makedirs(gen_dir, exist_ok=True)
        host = _to_host(metric_states, event)
        plain = {name: _to_plain(state) for name, state in host.items()}
        tree = {
            "schema": SCHEMA_VERSION,
            "generation": generation,
            "rank": rank,
            "world_size": world,
            "step": int(cursor),
            "metrics": plain,
            "payload": payload,
            # the federation's epoch ledger (None without a federation),
            # in the JAX package's slot and numpy form
            "federation": fed_payload,
        }
        blob = pickle.dumps(tree, protocol=pickle.HIGHEST_PROTOCOL)
        # phase 1: the shard file, written in place (torn writes allowed:
        # the manifest is the commit record), then fsynced through to the
        # directory entry
        shard = os.path.join(gen_dir, self._shard_name(rank))
        with open(shard, "wb") as f:
            half = len(blob) // 2
            f.write(blob[:half])
            f.flush()
            self._fault("mid-shard", generation)
            f.write(blob[half:])
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(gen_dir)
        entry = {
            "rank": rank,
            "generation": generation,
            "sha256": hashlib.sha256(blob).hexdigest(),
            # the canonical leaf digest: catches a decodes-fine-but-wrong
            # shard independently of the file bytes
            "state_digest": _digest(_from_plain(plain)),
            "bytes": len(blob),
            "step": int(cursor),
        }
        # phase 2: every rank reports its shard digest; the leader commits
        entries = group.allgather_object(entry)  # tev: disable=cross-thread-collective -- async snapshots run on a DEDICATED whole-world subgroup (self._comm) whose collective sequence nothing else shares; sync mode runs on the caller thread
        self._fault("pre-manifest", generation)
        if rank == 0:
            self._commit_manifest(gen_dir, generation, entries, cursor, world)
        self._fault("post-manifest", generation)
        if rank == 0:
            self._rotate()
        self.snapshots_written += 1
        return len(blob)

    def _commit_manifest(
        self,
        gen_dir: str,
        generation: int,
        entries: List[Dict[str, Any]],
        cursor: int,
        world: int,
    ) -> None:
        steps = sorted({int(e["step"]) for e in entries})
        # ranks derive generation numbers independently (each scans the
        # shared directory at construction): a divergence would commit a
        # manifest whose digests reference shards in ANOTHER gen dir —
        # fail loudly at commit time instead of at every later restore
        gens = sorted({int(e.get("generation", generation)) for e in entries})
        if (
            steps != [int(cursor)]
            or gens != [generation]
            or len(entries) != world
        ):
            raise RuntimeError(
                f"snapshot generation {generation} is inconsistent: ranks "
                f"report steps {steps} / generations {gens} over "
                f"{len(entries)} shards (leader expected step {cursor} of "
                f"generation {generation} from {world} ranks) — every "
                "rank must call snapshot()/step_done() in the same order, "
                "against the same bundle directory state"
            )
        manifest = {
            "schema": SCHEMA_VERSION,
            "generation": generation,
            "world_size": world,
            "step": int(cursor),
            "shards": [
                {
                    "rank": int(e["rank"]),
                    "sha256": e["sha256"],
                    "state_digest": e["state_digest"],
                    "bytes": int(e["bytes"]),
                }
                for e in sorted(entries, key=lambda e: int(e["rank"]))
            ],
        }
        tmp = os.path.join(gen_dir, "MANIFEST.tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        # the atomic commit point: the generation exists once this lands
        os.replace(tmp, os.path.join(gen_dir, MANIFEST_NAME))
        _fsync_dir(gen_dir)
        _fsync_dir(self.directory)

    # --------------------------------------------------- generations on disk

    def _scan_generations(self) -> List[Tuple[int, str]]:
        """All generation dirs (committed or not), ascending."""
        out: List[Tuple[int, str]] = []
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return out
        for name in names:
            m = _GEN_RE.match(name)
            if m:
                out.append((int(m.group(1)), os.path.join(self.directory, name)))
        out.sort()
        return out

    def _quarantine_marker(self, generation: int) -> str:
        return os.path.join(self.directory, f"quarantined-{generation:08d}")

    def _quarantined(self) -> List[int]:
        """Generation numbers the leader quarantined (their markers): a
        rank that scans after the leader removed a generation still sees
        its number, so every rank continues the numbering above it."""
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        return [int(n[len("quarantined-"):]) for n in names
                if n.startswith("quarantined-") and n[len("quarantined-"):].isdigit()]

    def _committed_generations(self) -> List[Tuple[int, str]]:
        return [
            (g, d)
            for g, d in self._scan_generations()
            if os.path.exists(os.path.join(d, MANIFEST_NAME))
        ]

    def _rotate(self) -> None:
        """Leader-only retention sweep: keep the newest ``retention``
        COMMITTED generations; drop everything older than the cut (torn
        uncommitted leftovers older than the cut included). Uncommitted
        dirs NEWER than the cut are in-flight and stay."""
        committed = self._committed_generations()
        if len(committed) <= self.retention:
            return
        cut = committed[-self.retention][0]
        for gen, path in self._scan_generations():
            if gen < cut:
                shutil.rmtree(path, ignore_errors=True)

    # -------------------------------------------------------------- restore

    def restore(self) -> Optional[RestoreResult]:
        """Recover the newest usable generation (see module docstring).

        Returns ``None`` when no committed generation exists (fresh
        start). Torn/corrupt generations are skipped with a
        ``RuntimeWarning``; a usable one restores every metric's state
        (redistributed via ``merge_state`` if the world size changed) and
        the step cursor, fencing the resumed loop against double counts.
        """
        self._raise_writer_error()
        restore_t0 = time.monotonic()
        world = self._group.world_size
        rank = self._group.rank
        unusable: List[Tuple[int, str]] = []
        for generation, gen_dir in reversed(self._committed_generations()):
            try:
                manifest, shards = self._load_generation(generation, gen_dir)
            except _BundleError as e:
                warnings.warn(
                    f"snapshot generation {generation} is unusable ({e}); "
                    "falling back to the previous generation",
                    RuntimeWarning,
                )
                unusable.append((generation, gen_dir))
                continue
            if rank == 0 and unusable:
                # quarantine the unusable COMMITTED generations this
                # restore skipped: left in place they would count toward
                # retention and could rotate out the very generation that
                # just saved the run (validation is deterministic over
                # the shared disk, so every rank skipped the same set;
                # only the leader deletes)
                for bad_gen, bad_dir in unusable:
                    warnings.warn(
                        f"removing unusable snapshot generation {bad_gen} "
                        "so it cannot occupy a retention slot",
                        RuntimeWarning,
                    )
                    # a marker first, then the removal: a rank whose scan
                    # comes after the removal still numbers past it
                    open(self._quarantine_marker(bad_gen), "w").close()
                    shutil.rmtree(bad_dir, ignore_errors=True)
            old_world = int(manifest["world_size"])
            assigned = _assign_shards(old_world, world)[rank]
            self._restore_metrics(shards, assigned, gen_dir)
            if self._federation is not None:
                if old_world == world:
                    # same world: this rank's own old shard carries its
                    # ledger (replacement by epoch makes any staleness
                    # safe: re-deliveries are discarded, un-acked deltas
                    # re-derive from the cumulative snapshot)
                    self._federation.load_ledger(shards[rank].get("federation"))
                else:
                    warnings.warn(
                        "world size changed across restore "
                        f"({old_world} -> {world}); starting a fresh "
                        "federation ledger (anti-entropy re-converges it "
                        "via full snapshots)",
                        RuntimeWarning,
                    )
            if self._plane is not None:
                # the restored state replaces what every published and
                # merged plane snapshot describes
                self._plane.invalidate()
            self._cursor = int(manifest["step"])
            self._since_snapshot = 0
            # pin the numbering by CONSENSUS: every rank walked the same
            # committed list and restored the same generation, so both
            # the restored number and the skipped (quarantined) set are
            # identical rank-wide — unlike each rank's construction-time
            # scan. Numbering continues ABOVE the quarantined
            # generations rather than reusing their numbers: a reused
            # number would let a fast rank's fresh shard write race the
            # leader's quarantine rmtree of the same directory.
            self._next_gen = 1 + max(
                [generation] + [g for g, _ in unusable] + self._quarantined()
            )
            seconds = time.monotonic() - restore_t0
            _obs_counters.note_restore(seconds)
            if _OBS.enabled:
                _obs_hist.observe("restore", seconds)
                _OBS.set_step(self._cursor)
                _OBS.record(
                    RestoreEvent(
                        rank=rank,
                        step=self._cursor,
                        generation=generation,
                        restored_step=self._cursor,
                        old_world=old_world,
                        new_world=world,
                        seconds=seconds,
                    )
                )
            return RestoreResult(
                step=self._cursor,
                generation=generation,
                world_size=old_world,
                assigned_ranks=assigned,
                payloads=tuple(shards[r]["payload"] for r in assigned),
            )
        return None

    def _load_generation(
        self, generation: int, gen_dir: str
    ) -> Tuple[Dict[str, Any], List[Dict[str, Any]]]:
        """Validate and load EVERY shard of one committed generation: a
        single torn shard disqualifies the whole generation (no partial
        generation is ever loaded)."""
        manifest = _read_manifest(gen_dir)
        entries = sorted(manifest["shards"], key=lambda e: int(e["rank"]))
        if [int(e["rank"]) for e in entries] != list(range(len(entries))):
            raise _BundleError(f"manifest shard ranks are not 0..{len(entries) - 1}")
        return manifest, [_load_shard(gen_dir, manifest, e) for e in entries]

    def _restore_metrics(
        self,
        shards: List[Dict[str, Any]],
        assigned: Tuple[int, ...],
        gen_dir: str,
    ) -> None:
        """Load this rank's assigned old shards into the live metrics:
        the first shard's state loads directly, the rest merge in through
        ``merge_state`` in old-rank order (the redistribution step of a
        world-size-change resume). Ranks with no assignment keep freshly
        reset metrics, the merge identity.

        SHARDED metrics (``Metric(shard=...)``) and keyed metric tables
        (``_hash_partitioned``) redistribute otherwise when the world size
        changed: their payloads are slices of ONE logical state plus
        outboxes that may target any slice, so every new rank merges ALL
        old shards (the reassembling merge rebuilds the logical state
        once) and re-slices to its own new shard or owned keys
        (``_reshard_to_own``; a table re-hashes ``hash % new_world``);
        slices partition the cells and keys, so every contribution lands
        once. At an unchanged world size each shard
        loads as it is.

        Under donation ``reset`` and ``load_state_dict`` write a state of
        unchanged dtype and shape into the live tensor, so the CUDA graphs
        that write it (``metrics/_fuse.py``) survive the restore; a state
        whose shape changed (a buffer's capacity) is replaced, and the
        graphs writing the old tensor are dropped with it."""
        from torcheval_tpu_torch.metrics.toolkit import _restore_state_types, clone_metric

        world_changed = len(shards) != self._group.world_size
        for name, metric in self.metrics.items():
            metric.reset()
            # axis-sharded states and hash-partitioned key tables
            # (torcheval_tpu_torch.table.MetricTable) redistribute alike:
            # reassemble the logical state from every old shard, then
            # re-slice to this rank's new shard or owned key set
            sharded = bool(getattr(metric, "_sharded_states", None)) or bool(
                getattr(metric, "_hash_partitioned", False)
            )
            metric_assigned = tuple(range(len(shards))) if sharded and world_changed else assigned
            states = []
            for old_rank in metric_assigned:
                state = shards[old_rank]["metrics"].get(name)
                if state is None:
                    raise RuntimeError(
                        f"snapshot at {gen_dir} has no state for metric "
                        f"{name!r} — was the collection renamed between "
                        "runs?"
                    )
                states.append(_from_plain(state))
            if not states:
                continue
            template = clone_metric(metric) if len(states) > 1 else None
            context = f"snapshot at {gen_dir}"
            validate_state_dict(metric, states[0], context=context, prefix=f"{name}.")
            metric.load_state_dict(_restore_state_types(states[0]))
            peers = []
            for state in states[1:]:
                peer = clone_metric(template)
                validate_state_dict(peer, state, context=context, prefix=f"{name}.")
                peer.load_state_dict(_restore_state_types(state))
                peers.append(peer)
            if peers:
                metric.merge_state(peers)
            if sharded and world_changed:
                metric._reshard_to_own()
