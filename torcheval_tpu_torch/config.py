"""Global configuration for torcheval_tpu_torch (counterpart of
``torcheval_tpu/config.py``, with state of its own: toggling the JAX
package's knobs leaves these untouched, and the reverse).

Validation comes in two tiers. Shape and dtype checks read only tensor
metadata and always run. Value checks read a tensor back to the host,
which on a CUDA card synchronizes the stream inside ``update()``; they run
only when asked for:

- ``debug_validation`` (env ``TORCHEVAL_TPU_DEBUG``, default off): range
  checks on targets, probabilities and images at the functional and
  class entry points, and the precision/recall/F1 notices about classes
  with no instances.
- ``validate_inputs`` (env ``TORCHEVAL_TPU_VALIDATE_INPUTS``: ``off``,
  ``warn`` or ``raise``, default ``off``): a NaN/Inf guard on every float
  input that passes through a class metric's ``update``.

Two knobs shape how an update runs:

- ``shape_bucketing`` (env ``TORCHEVAL_TPU_SHAPE_BUCKETING``, default
  off): ragged batch axes are padded with zeros to power-of-two buckets
  and a mask-aware twin of the kernel keeps the padding out of every
  state (``metrics/_bucket.py``), so a ragged stream sees at most
  ``bucket_bound(max_batch)`` shapes; on CUDA each bucket's update is then
  one CUDA-graph replay (``metrics/_fuse.py``).
- ``update_donation`` (env ``TORCHEVAL_TPU_UPDATE_DONATION``): updates
  write the new state into the state tensor in place. Unset, it is on for
  a metric whose state lives on CUDA and off for one on the CPU. On CUDA
  it also lets ``toolkit.update_collection`` run its unbucketed plans as
  one CUDA-graph replay per input signature that repeats
  (``metrics/_fuse.py``); off, they run eagerly.

Sync resilience (``resilience.ResilientGroup``): ``sync_timeout``,
``sync_retries``, ``sync_degradation`` (``raise``/``local``/``quorum``),
``sync_quorum`` and ``sync_reform_after``, scoped together by
``sync_resilience(...)``; envs ``TORCHEVAL_TPU_SYNC_TIMEOUT``,
``_SYNC_RETRIES``, ``_SYNC_DEGRADATION``, ``_SYNC_QUORUM`` and
``_SYNC_REFORM_AFTER``. Elastic snapshots (``elastic.ElasticSession``):
``snapshot_interval`` and ``snapshot_retention``; envs
``TORCHEVAL_TPU_SNAPSHOT_INTERVAL`` and ``_SNAPSHOT_RETENTION``.

Metric tables (``torcheval_tpu_torch.table``): ``tenant_staleness_epochs``,
the default per-tenant staleness budget; env
``TORCHEVAL_TPU_TENANT_STALENESS``.

The wire ladder (``torcheval_tpu_torch.wire``): ``wire_ladder`` (env
``TORCHEVAL_TPU_WIRE_LADDER``; legacy ``sync_compression``, env
``TORCHEVAL_TPU_SYNC_COMPRESSION``), ``wire_rung_for``,
``wire_block_size`` (env ``TORCHEVAL_TPU_WIRE_BLOCK``, default 32), with
setters and ``wire_ladder_mode``/``sync_compression_mode``. Federation
and failover: ``federation_staleness_epochs`` (env
``TORCHEVAL_TPU_FEDERATION_STALENESS``, default 4) and
``failover_detect_after`` (env ``TORCHEVAL_TPU_FAILOVER_DETECT_AFTER``,
default 2).

Observability (``torcheval_tpu_torch.obs``): ``observability(...)``
scopes the event recorder, its JSONL writer and Chrome trace, the stall
watchdog, the health server and the SLO monitor; ``observability_enabled``
and ``set_observability``; env ``TORCHEVAL_TPU_OBSERVABILITY`` (truthy
enables at import, a ``*.jsonl`` value also attaches the writer).

The environment names, spellings, defaults and policies are the JAX
package's.
"""

from __future__ import annotations

import math
import os
import warnings
from contextlib import contextmanager
from typing import Iterator, Optional

# accepted spellings for boolean env knobs
_TRUTHY = ("1", "true", "yes", "on")
_FALSY = ("0", "false", "no", "off")


def env_truthy(name: str) -> bool:
    """True when env var ``name`` is set to a truthy spelling."""
    return os.environ.get(name, "").lower() in _TRUTHY


def _env_invalid(name: str, raw: str, why: str, default) -> None:
    warnings.warn(
        f"ignoring env {name}={raw!r}: {why}; using default {default!r}",
        RuntimeWarning,
    )


def _env_choice(name: str, default: str, choices) -> str:
    """Env var ``name`` as one of ``choices`` (case-insensitive); unset
    gives ``default``, and an unknown value warns and gives ``default``
    too, so a typo cannot quietly pick another policy."""
    raw = os.environ.get(name, "").strip().lower()
    if not raw:
        return default
    if raw not in choices:
        _env_invalid(name, raw, f"must be one of {choices}", default)
        return default
    return raw


def _check_timeout(seconds: float) -> float:
    seconds = float(seconds)
    if not math.isfinite(seconds) or seconds <= 0:
        # a 0/negative/NaN deadline would disable the deadline: the
        # unbounded hang the knob exists to prevent
        raise ValueError(
            f"sync_timeout must be a positive finite number of seconds "
            f"(or None for no deadline), got {seconds}"
        )
    return seconds


def _env_timeout(name: str) -> Optional[float]:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return None
    try:
        return _check_timeout(float(raw))
    except ValueError:
        _env_invalid(name, raw, "not a positive finite number", None)
        return None


def _env_int(name: str, default: int, minimum: int) -> int:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        value = int(raw)
    except ValueError:
        _env_invalid(name, raw, "not an integer", default)
        return default
    if value < minimum:
        _env_invalid(name, raw, f"must be >= {minimum}", default)
        return default
    return value


def _env_fraction(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        value = float(raw)
    except ValueError:
        _env_invalid(name, raw, "not a number", default)
        return default
    if not 0.0 < value <= 1.0:
        _env_invalid(name, raw, "must be a fraction in (0, 1]", default)
        return default
    return value


# ------------------------------------------------------ debug validation

_debug_validation: bool = env_truthy("TORCHEVAL_TPU_DEBUG")


def debug_validation_enabled() -> bool:
    """True when value-level (host-sync-forcing) input validation is on."""
    return _debug_validation


def set_debug_validation(enabled: bool) -> None:
    global _debug_validation
    _debug_validation = bool(enabled)


@contextmanager
def debug_validation(enabled: bool = True) -> Iterator[None]:
    """Context manager enabling value-level input validation.

    >>> with debug_validation():
    ...     metric.update(inputs, targets)   # raises on out-of-range values
    """
    global _debug_validation
    prev = _debug_validation
    _debug_validation = enabled
    try:
        yield
    finally:
        _debug_validation = prev


# ------------------------------------------------------ input guardrails

_VALIDATE_POLICIES = ("off", "warn", "raise")

_validate_inputs: str = _env_choice(
    "TORCHEVAL_TPU_VALIDATE_INPUTS", "off", _VALIDATE_POLICIES
)


def validate_inputs_policy() -> str:
    """NaN/Inf guard at the ``Metric.update`` front door: ``"off"``
    (default -- the check reads the input back to the host), ``"warn"``,
    or ``"raise"``. Env ``TORCHEVAL_TPU_VALIDATE_INPUTS``."""
    return _validate_inputs


def set_validate_inputs(policy: str) -> None:
    global _validate_inputs
    if policy not in _VALIDATE_POLICIES:
        raise ValueError(
            f"validate_inputs policy must be one of {_VALIDATE_POLICIES}, "
            f"got {policy!r}"
        )
    _validate_inputs = policy


@contextmanager
def validate_inputs(policy: str = "raise") -> Iterator[None]:
    """Context manager enabling the NaN/Inf input guard.

    >>> with validate_inputs():
    ...     metric.update(inputs, targets)   # raises on NaN/Inf inputs
    """
    global _validate_inputs
    prev = _validate_inputs
    set_validate_inputs(policy)
    try:
        yield
    finally:
        _validate_inputs = prev


# ------------------------------------------------------ shape bucketing

_shape_bucketing: bool = env_truthy("TORCHEVAL_TPU_SHAPE_BUCKETING")


def shape_bucketing_enabled() -> bool:
    """True when variable-shape updates are padded to power-of-two buckets."""
    return _shape_bucketing


def set_shape_bucketing(enabled: bool) -> None:
    global _shape_bucketing
    _shape_bucketing = bool(enabled)


@contextmanager
def shape_bucketing(enabled: bool = True) -> Iterator[None]:
    """Context manager enabling shape bucketing.

    Inside the context, bucket-aware metrics pad ragged batch axes with
    zeros up to power-of-two buckets and pass the valid extents to a
    mask-aware twin of their kernel, so padded rows add exactly zero to
    every state and ``compute()`` matches the unbucketed stream.

    >>> with shape_bucketing():
    ...     for batch in loader:           # ragged last batch is fine
    ...         metric.update(batch.scores, batch.labels)
    """
    global _shape_bucketing
    prev = _shape_bucketing
    _shape_bucketing = enabled
    try:
        yield
    finally:
        _shape_bucketing = prev


# -------------------------------------------------------- update donation


def _env_donation() -> Optional[bool]:
    raw = os.environ.get("TORCHEVAL_TPU_UPDATE_DONATION", "").lower()
    if raw in _TRUTHY:
        return True
    if raw in _FALSY:
        return False
    return None


# None: no override, the default follows each metric's device
_update_donation: Optional[bool] = _env_donation()


def update_donation_enabled(device=None) -> bool:
    """True when updates of a metric on ``device`` DONATE their state
    tensors: the new state is written into the old one in place
    (``add_``/``copy_`` wherever the result keeps the state's dtype and
    shape), so an update allocates no state, and on CUDA a bucketed update,
    or a panel's unbucketed plans whose input signature repeats, can be a
    CUDA-graph replay that writes the live states. Default: on
    for a CUDA device (``None`` means the card, as for a metric's state)
    and off for the CPU; env ``TORCHEVAL_TPU_UPDATE_DONATION`` or
    :func:`set_update_donation` overrides either way.

    Consequence when on: ``state_dict()`` hands out copies and
    ``compute()`` results are copied where they would be a state tensor
    itself, but a state attribute read before an update changes with it.
    """
    if _update_donation is not None:
        return _update_donation
    return device is None or str(device).startswith("cuda")


def set_update_donation(enabled: Optional[bool]) -> None:
    """Force donation on or off for every metric; ``None`` restores the
    per-device default."""
    global _update_donation
    _update_donation = None if enabled is None else bool(enabled)


@contextmanager
def update_donation(enabled: bool = True) -> Iterator[None]:
    """Scoped override of :func:`update_donation_enabled`."""
    global _update_donation
    prev = _update_donation
    _update_donation = bool(enabled)
    try:
        yield
    finally:
        _update_donation = prev


# --------------------------------------------------------- sync resilience

_SYNC_POLICIES = ("raise", "local", "quorum")

_sync_timeout: Optional[float] = _env_timeout("TORCHEVAL_TPU_SYNC_TIMEOUT")
_SYNC_RETRIES_DEFAULT = 2
_sync_retries: int = _env_int(
    "TORCHEVAL_TPU_SYNC_RETRIES", _SYNC_RETRIES_DEFAULT, minimum=0
)
_sync_degradation: str = _env_choice(
    "TORCHEVAL_TPU_SYNC_DEGRADATION", "raise", _SYNC_POLICIES
)
_sync_quorum: float = _env_fraction("TORCHEVAL_TPU_SYNC_QUORUM", 0.5)


def sync_timeout() -> Optional[float]:
    """Per-collective metric-sync deadline in seconds (``None`` = wait
    forever, the reference's behavior). Env ``TORCHEVAL_TPU_SYNC_TIMEOUT``."""
    return _sync_timeout


def set_sync_timeout(seconds: Optional[float]) -> None:
    global _sync_timeout
    _sync_timeout = None if seconds is None else _check_timeout(seconds)


def sync_retries() -> int:
    """Extra attempts after a transient sync failure or timeout (default 2).
    Env ``TORCHEVAL_TPU_SYNC_RETRIES``."""
    return _sync_retries


def set_sync_retries(retries: int) -> None:
    global _sync_retries
    if retries < 0:
        raise ValueError(f"sync_retries must be >= 0, got {retries}")
    _sync_retries = int(retries)


def sync_degradation() -> str:
    """What a failed sync degrades to: ``"raise"`` (typed error -- default),
    ``"local"`` (unsynced local state, flagged stale), or ``"quorum"``
    (merge the surviving ranks). Env ``TORCHEVAL_TPU_SYNC_DEGRADATION``."""
    return _sync_degradation


def check_sync_policy(policy: str) -> str:
    """The one validator for degradation-policy names, shared by the
    setter here and ``resilience.ResilientGroup``."""
    if policy not in _SYNC_POLICIES:
        raise ValueError(
            f"sync degradation policy must be one of {_SYNC_POLICIES}, "
            f"got {policy!r}"
        )
    return policy


def set_sync_degradation(policy: str) -> None:
    global _sync_degradation
    _sync_degradation = check_sync_policy(policy)


def sync_quorum() -> float:
    """Minimum participating fraction of world size for the ``quorum``
    policy (default 0.5). Env ``TORCHEVAL_TPU_SYNC_QUORUM``."""
    return _sync_quorum


def set_sync_quorum(fraction: float) -> None:
    global _sync_quorum
    if not 0.0 < fraction <= 1.0:
        raise ValueError(f"quorum must be in (0, 1], got {fraction}")
    _sync_quorum = float(fraction)


def sync_resilience_configured() -> bool:
    """True when a behavior-bearing sync-resilience knob departs from the
    all-ranks-alive default: the toolkit then wraps the process group in
    a ``ResilientGroup`` itself. (``sync_quorum`` alone does not: it only
    tunes the ``quorum`` policy.)"""
    return (
        _sync_timeout is not None
        or _sync_degradation != "raise"
        or _sync_retries != _SYNC_RETRIES_DEFAULT
    )


@contextmanager
def sync_resilience(
    *,
    timeout: Optional[float] = None,
    retries: Optional[int] = None,
    degradation: Optional[str] = None,
    quorum: Optional[float] = None,
) -> Iterator[None]:
    """Context manager scoping the sync-resilience defaults.

    >>> with sync_resilience(timeout=30.0, degradation="quorum"):
    ...     value = sync_and_compute(metric)   # survives a dead host
    """
    global _sync_timeout, _sync_retries, _sync_degradation, _sync_quorum
    prev = (_sync_timeout, _sync_retries, _sync_degradation, _sync_quorum)
    try:
        # the setters run inside the try: a bad later knob must not leak
        # the earlier ones past the context
        if timeout is not None:
            set_sync_timeout(timeout)
        if retries is not None:
            set_sync_retries(retries)
        if degradation is not None:
            set_sync_degradation(degradation)
        if quorum is not None:
            set_sync_quorum(quorum)
        yield
    finally:
        (_sync_timeout, _sync_retries, _sync_degradation, _sync_quorum) = prev


# ------------------------------------------------------ elastic evaluation

_SNAPSHOT_INTERVAL_DEFAULT = 100
_snapshot_interval: int = _env_int(
    "TORCHEVAL_TPU_SNAPSHOT_INTERVAL", _SNAPSHOT_INTERVAL_DEFAULT, minimum=1
)
_SNAPSHOT_RETENTION_DEFAULT = 2
_snapshot_retention: int = _env_int(
    "TORCHEVAL_TPU_SNAPSHOT_RETENTION", _SNAPSHOT_RETENTION_DEFAULT, minimum=1
)
_sync_reform_after: int = _env_int("TORCHEVAL_TPU_SYNC_REFORM_AFTER", 0, minimum=0)


def snapshot_interval() -> int:
    """Default steps between ``elastic.ElasticSession`` snapshots
    (default 100). Env ``TORCHEVAL_TPU_SNAPSHOT_INTERVAL``."""
    return _snapshot_interval


def set_snapshot_interval(steps: int) -> None:
    global _snapshot_interval
    if int(steps) < 1:
        raise ValueError(f"snapshot_interval must be >= 1 step, got {steps}")
    _snapshot_interval = int(steps)


def snapshot_retention() -> int:
    """Default number of committed snapshot generations an
    ``elastic.ElasticSession`` keeps on disk (default 2: the newest plus
    one fallback for torn-write recovery). Env
    ``TORCHEVAL_TPU_SNAPSHOT_RETENTION``."""
    return _snapshot_retention


def set_snapshot_retention(generations: int) -> None:
    global _snapshot_retention
    if int(generations) < 1:
        raise ValueError(
            f"snapshot_retention must keep >= 1 generation, got {generations}"
        )
    _snapshot_retention = int(generations)


def sync_reform_after() -> int:
    """Persistent-failure escalation threshold for
    ``resilience.ResilientGroup``: after this many consecutive
    quorum-degraded syncs missing the same ranks, the group re-forms onto
    a survivors-only subgroup so later syncs run undegraded. ``0``
    (default) disables re-formation. The streak lives on the group
    object, so it needs a long-lived, explicitly constructed group. Env
    ``TORCHEVAL_TPU_SYNC_REFORM_AFTER``."""
    return _sync_reform_after


def set_sync_reform_after(syncs: int) -> None:
    global _sync_reform_after
    if int(syncs) < 0:
        raise ValueError(f"sync_reform_after must be >= 0 (0 disables), got {syncs}")
    _sync_reform_after = int(syncs)


# ------------------------------------------------- per-tenant staleness

_tenant_staleness: int = _env_int("TORCHEVAL_TPU_TENANT_STALENESS", 0, minimum=0)


def tenant_staleness_epochs() -> int:
    """Default per-tenant staleness budget (in drain epochs) stamped on
    metric tables built WITHOUT an explicit ``staleness_epochs=``
    (``table.tightest_staleness_budget`` reads the tightest live one).
    ``0`` (default) means unbudgeted. Env
    ``TORCHEVAL_TPU_TENANT_STALENESS``."""
    return _tenant_staleness


def set_tenant_staleness_epochs(epochs: int) -> None:
    global _tenant_staleness
    if int(epochs) < 0:
        raise ValueError(f"tenant staleness budget must be >= 0 (0 disables), got {epochs}")
    _tenant_staleness = int(epochs)


# ------------------------------------------------------ rank-loss failover

_FAILOVER_DETECT_AFTER_DEFAULT = 2
_failover_detect_after: int = _env_int(
    "TORCHEVAL_TPU_FAILOVER_DETECT_AFTER", _FAILOVER_DETECT_AFTER_DEFAULT, minimum=1
)


def failover_detect_after() -> int:
    """Consecutive missing-rank syncs before ``failover.FailureDomain``
    confirms a rank loss (default 2: one missed sync is routinely a
    transient; a tripped stall watchdog alongside a missing streak
    escalates at once). Env ``TORCHEVAL_TPU_FAILOVER_DETECT_AFTER``."""
    return _failover_detect_after


def set_failover_detect_after(syncs: int) -> None:
    global _failover_detect_after
    if int(syncs) < 1:
        raise ValueError(f"failover_detect_after must be >= 1 sync, got {syncs}")
    _failover_detect_after = int(syncs)


# -------------------------------------------------- cross-region federation

_FEDERATION_STALENESS_DEFAULT = 4
_federation_staleness: int = _env_int(
    "TORCHEVAL_TPU_FEDERATION_STALENESS", _FEDERATION_STALENESS_DEFAULT, minimum=1
)


def federation_staleness_epochs() -> int:
    """Default staleness bound (exchange rounds) of
    ``federation.Federation``: a remote region whose snapshot has not
    merged for more than this many rounds is declared dark (the federated
    read degrades to the surviving regions), and unless the federation
    overrides ``staleness_503`` the ``/healthz`` probe reports
    ``stale-region`` past the same bound. Env
    ``TORCHEVAL_TPU_FEDERATION_STALENESS``."""
    return _federation_staleness


def set_federation_staleness_epochs(rounds: int) -> None:
    global _federation_staleness
    if int(rounds) < 1:
        raise ValueError(f"federation staleness bound must be >= 1 round, got {rounds}")
    _federation_staleness = int(rounds)


# -------------------------------------------------- quantized wire ladder

# least -> most lossy, as ``wire.RUNGS``; "off" is the legacy
# sync_compression spelling of the exact rung
_WIRE_RUNGS = ("exact", "bf16", "int8")
_LEGACY_RUNGS = {"off": "exact", "bf16": "bf16", "int8": "int8"}

_WIRE_BLOCK_DEFAULT = 32
_wire_block: int = _env_int("TORCHEVAL_TPU_WIRE_BLOCK", _WIRE_BLOCK_DEFAULT, minimum=2)


def _coerce_rung(rung: str) -> str:
    rung = str(rung).strip().lower()
    rung = _LEGACY_RUNGS.get(rung, rung)
    if rung not in _WIRE_RUNGS:
        raise ValueError(
            f"wire rung must be one of {_WIRE_RUNGS} (or legacy 'off'), got {rung!r}"
        )
    return rung


def _parse_wire_ladder(raw: str) -> "dict[str, str]":
    """``"int8"`` (the default rung) or ``"*=bf16,MulticlassAUROC=int8"``
    (per-family overrides; families are metric class names)."""
    raw = raw.strip()
    if "=" not in raw:
        return {"*": _coerce_rung(raw)}
    policy: "dict[str, str]" = {}
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        family, _, rung = part.partition("=")
        policy[family.strip()] = _coerce_rung(rung)
    policy.setdefault("*", "exact")
    return policy


def _env_wire_ladder() -> "dict[str, str]":
    # the legacy env still sets the default-family rung
    legacy = _env_choice("TORCHEVAL_TPU_SYNC_COMPRESSION", "off", ("off", "bf16", "int8"))
    default = {"*": _LEGACY_RUNGS[legacy]}
    raw = os.environ.get("TORCHEVAL_TPU_WIRE_LADDER", "").strip()
    if not raw:
        return default
    try:
        return _parse_wire_ladder(raw)
    except ValueError:
        _env_invalid(
            "TORCHEVAL_TPU_WIRE_LADDER", raw, f"rungs must be one of {_WIRE_RUNGS}", default
        )
        return default


_wire_ladder: "dict[str, str]" = _env_wire_ladder()


def wire_ladder() -> "dict[str, str]":
    """The configured per-family wire ladder, ``{"*": default_rung,
    family: rung, ...}`` with rungs from ``exact | bf16 | int8`` (least
    to most lossy; ``torcheval_tpu_torch.wire``). Families are metric
    class names. The rung a family actually rides is this, capped by any
    drift-budget fallback: ``wire.effective_rung(family)``. Env
    ``TORCHEVAL_TPU_WIRE_LADDER`` (``"int8"`` or
    ``"*=bf16,MulticlassAUROC=int8"``); the legacy
    ``TORCHEVAL_TPU_SYNC_COMPRESSION`` still sets the default rung. The
    eager and federation syncs read it a call; the in-step sync
    (``metrics.sharded``) reads it when built, so pass ``compression=``
    there explicitly."""
    return dict(_wire_ladder)


def wire_rung_for(family: str) -> str:
    """``family``'s configured rung (its entry, else the ``"*"`` default),
    without the fallback caps (``wire.effective_rung`` applies those)."""
    return _wire_ladder.get(family, _wire_ladder.get("*", "exact"))


def set_wire_ladder(policy) -> None:
    """Set the ladder: one rung name (``"int8"``, every family), a
    ``family=rung`` spec string, or a mapping ``{family: rung}`` (a
    missing ``"*"`` defaults to ``exact``)."""
    global _wire_ladder
    if isinstance(policy, str):
        _wire_ladder = _parse_wire_ladder(policy)
        return
    parsed = {str(k): _coerce_rung(v) for k, v in dict(policy).items()}
    parsed.setdefault("*", "exact")
    _wire_ladder = parsed


@contextmanager
def wire_ladder_mode(policy) -> Iterator[None]:
    """Scope the wire-ladder policy::

        with wire_ladder_mode("int8"):
            value = sync_and_compute(metric)   # ~3.6x fewer float bytes
    """
    global _wire_ladder
    prev = _wire_ladder
    set_wire_ladder(policy)
    try:
        yield
    finally:
        _wire_ladder = prev


def wire_block_size() -> int:
    """The int8 rung's quantization block: elements sharing one float32
    scale (default 32: ``size * (1 + 4/block)`` wire bytes against
    ``4 * size`` exact, with max error ``amax(block) / 254``). Env
    ``TORCHEVAL_TPU_WIRE_BLOCK``."""
    return _wire_block


def set_wire_block_size(block: int) -> None:
    global _wire_block
    if int(block) < 2:
        raise ValueError(f"wire block size must be >= 2, got {block}")
    _wire_block = int(block)


# the legacy single-policy view of the ladder: the compression policy is
# the ladder's default-family rung
_COMPRESSION_POLICIES = ("off", "bf16", "int8")


def sync_compression() -> str:
    """The ladder's default-family rung, ``"off"`` for ``exact`` (the
    pre-ladder single-policy API; prefer :func:`wire_ladder`)."""
    rung = _wire_ladder.get("*", "exact")
    return "off" if rung == "exact" else rung


def set_sync_compression(policy: str) -> None:
    """Set the ladder's ``"*"`` default rung, keeping per-family
    overrides."""
    global _wire_ladder
    if policy not in _COMPRESSION_POLICIES:
        raise ValueError(
            f"sync_compression must be one of {_COMPRESSION_POLICIES}, got {policy!r}"
        )
    ladder = dict(_wire_ladder)
    ladder["*"] = _LEGACY_RUNGS[policy]
    _wire_ladder = ladder


@contextmanager
def sync_compression_mode(policy: str = "bf16") -> Iterator[None]:
    """Scope the legacy default-rung policy."""
    global _wire_ladder
    prev = _wire_ladder
    set_sync_compression(policy)
    try:
        yield
    finally:
        _wire_ladder = prev


# ---------------------------------------------------------- observability

def observability_enabled() -> bool:
    """True when the process-global event recorder
    (``torcheval_tpu_torch.obs``) is recording. Off by default — when off, the
    instrumented hot paths cost one attribute read and add no host sync
    and no collective. Env
    ``TORCHEVAL_TPU_OBSERVABILITY`` (truthy enables at import; a value
    ending in ``.jsonl`` also attaches the JSONL writer)."""
    from torcheval_tpu_torch.obs.recorder import RECORDER

    return RECORDER.enabled


def set_observability(enabled: bool) -> None:
    """Turn the global event recorder on/off process-wide. Prefer the
    scoped :func:`observability` context manager in eval code."""
    from torcheval_tpu_torch.obs.recorder import RECORDER

    if enabled:
        RECORDER.enable()
    else:
        RECORDER.disable()


@contextmanager
def observability(
    enabled: bool = True,
    *,
    jsonl: Optional[str] = None,
    capacity: Optional[int] = None,
    chrome_trace: Optional[str] = None,
    watchdog: Optional[float] = None,
    serve: Optional[int] = None,
    slos=None,
) -> Iterator[None]:
    """Context manager scoping structured event recording.

    Inside the context the global recorder (``torcheval_tpu_torch.obs``)
    collects typed lifecycle events — updates, computes, syncs (with
    provenance + wire bytes), resilience retries/degradations, elastic
    snapshots/restores, CUDA-graph captures — into a bounded ring buffer,
    with causal trace/span ids connecting them into per-step trees, and
    optionally streams
    them to ``jsonl`` via the async line writer (drained and closed on
    exit). ``chrome_trace`` additionally writes the scope's retained
    events as Chrome trace-event JSON (``obs.export_chrome_trace``,
    loadable in Perfetto) when the scope exits — including an exit by
    exception, so a crashed eval leaves its timeline behind.

    Live-diagnosis layer: ``watchdog=<seconds>`` arms the
    stall watchdog (``obs.watchdog``) for the scope — a collective
    in-flight past that deadline dumps every thread's flight ring, the
    stalled thread's span path, and a ``StallEvent`` before the process
    dies; ``serve=<port>`` runs the background health server
    (``obs.server``: ``/metrics``, ``/healthz``, ``/flight``,
    ``/report``; port 0 = ephemeral — read it off
    ``obs.server.current_server().port``); ``slos=[SloSpec, ...]`` arms
    the SLO/anomaly monitor (``obs.monitor``; pass ``[]`` for
    drift-detection-only). All three are torn down at scope exit —
    watchdog disarmed, server stopped, monitor disarmed — exit by
    exception included.

    >>> with observability(jsonl="/tmp/eval-events.jsonl"):
    ...     value = sync_and_compute(metric)
    >>> # obs.format_report() / obs.read_jsonl(...) to inspect
    """
    from torcheval_tpu_torch.obs.flight import FLIGHT
    from torcheval_tpu_torch.obs.recorder import RECORDER

    prev_enabled = RECORDER.enabled
    prev_writer = RECORDER._writer
    # enable() adds the flight recorder's "recorder" source; the scope
    # restores RECORDER.enabled by attribute (pause semantics), so the
    # source must be restored the same way or flight recording leaks
    # past the scope
    prev_flight = "recorder" in FLIGHT._sources
    # pre-existing process-global live-diagnosis instances: the scope
    # must hand them BACK at exit (an operator's env-armed watchdog may
    # not be silently stripped by a narrower scoped one)
    scoped_watchdog = scoped_server = False
    scoped_monitor = False
    prev_watchdog = prev_monitor = None
    prev_server_addr = None
    # NOT sys.exc_info(): inside an outer `except` handler that call
    # reports the already-HANDLED exception, which would both mask a
    # chrome-trace export error after a fully successful scope and
    # mislabel a clean exit as a crash — only an exception escaping the
    # scope BODY counts
    propagating: Optional[BaseException] = None
    events_before = RECORDER.log.total
    try:
        # arming INSIDE the try: a failed start (e.g. the serve port is
        # already bound) still runs the teardown below, so an armed
        # watchdog/monitor cannot leak past a scope that never opened
        if watchdog is not None:
            from torcheval_tpu_torch.obs import watchdog as _wd_mod

            prev_watchdog = _wd_mod._WATCHDOG
            _wd_mod.arm_watchdog(watchdog)
            scoped_watchdog = True
        if slos is not None:
            from torcheval_tpu_torch.obs import monitor as _mon_mod

            prev_monitor = _mon_mod._MONITOR
            _mon_mod.arm_monitor(slos=tuple(slos))
            scoped_monitor = True
        if serve is not None:
            from torcheval_tpu_torch.obs.server import current_server, start_server

            running = current_server()
            if running is not None:
                prev_server_addr = (running.port, running.host)
            start_server(serve)
            scoped_server = True
        if enabled:
            if jsonl is not None:
                # detach (don't close) any writer attached OUTSIDE this
                # scope before enable() installs this scope's — the outer
                # stream must keep working after the scope exits
                RECORDER._writer = None
            RECORDER.enable(jsonl=jsonl, capacity=capacity)
        else:
            # pause recording only — a writer attached OUTSIDE this scope
            # must survive the scope (full disable() would close it)
            RECORDER.enabled = False
        yield
    except BaseException as e:
        propagating = e
        raise
    finally:
        # live-diagnosis teardown first (the server reads the monitor
        # and watchdog, so it stops before they disarm); each RESTORES
        # any process-global instance that pre-existed the scope. None
        # of these raise by design, and the nested finally guarantees
        # the recorder/writer restore below runs regardless
        try:
            if scoped_server:
                from torcheval_tpu_torch.obs.server import start_server, stop_server

                stop_server()
                if prev_server_addr is not None:
                    start_server(*prev_server_addr)
            if scoped_monitor:
                from torcheval_tpu_torch.obs.monitor import _restore_monitor

                _restore_monitor(prev_monitor)
            if scoped_watchdog:
                from torcheval_tpu_torch.obs.watchdog import _restore_watchdog

                _restore_watchdog(prev_watchdog)
        finally:
            export_error: Optional[BaseException] = None
            if enabled and chrome_trace is not None:
                # write the timeline even when the scope exits by
                # exception (a crashed eval leaves its trace behind); an
                # unwritable path surfaces — but only after the
                # recorder/writer state below is restored, and never
                # MASKING a propagating error. Only THIS SCOPE's events
                # (the documented contract): the ring is process-global
                # and may hold an earlier eval's events — export the
                # suffix recorded since entry. (Events beyond the ring
                # capacity are gone either way; tail(0) would mean ALL
                # retained, hence the explicit [] branch.)
                from torcheval_tpu_torch.obs.export import export_chrome_trace

                new = RECORDER.log.total - events_before
                scope_events = RECORDER.log.tail(new) if new > 0 else []
                try:
                    export_chrome_trace(scope_events, path=chrome_trace)
                except Exception as e:  # noqa: BLE001 — re-raised below
                    export_error = e
            # restore recorder state FIRST (close may raise a ferried
            # writer error to the caller), then close ONLY the writer
            # THIS scope attached — never one inherited from outside
            scoped = RECORDER._writer
            RECORDER._writer = prev_writer
            RECORDER.enabled = prev_enabled
            if prev_flight:
                FLIGHT.enable("recorder")
            else:
                FLIGHT.disable("recorder")
            if scoped is not None and scoped is not prev_writer:
                scoped.close()
            if export_error is not None and propagating is None:
                raise export_error
