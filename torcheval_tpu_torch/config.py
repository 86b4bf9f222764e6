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
  a metric whose state lives on CUDA and off for one on the CPU.

The environment names, spellings, defaults and policies are the JAX
package's.
"""

from __future__ import annotations

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


def _env_choice(name: str, default: str, choices) -> str:
    """Env var ``name`` as one of ``choices`` (case-insensitive); unset
    gives ``default``, and an unknown value warns and gives ``default``
    too, so a typo cannot quietly pick another policy."""
    raw = os.environ.get(name, "").strip().lower()
    if not raw:
        return default
    if raw not in choices:
        warnings.warn(
            f"ignoring env {name}={raw!r}: must be one of {choices}; "
            f"using default {default!r}",
            RuntimeWarning,
        )
        return default
    return raw


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
    shape), so an update allocates no state, and on CUDA a bucketed update
    can be a CUDA-graph replay that writes the live states. Default: on
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
