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

The environment names, spellings, defaults and policies are the JAX
package's.
"""

from __future__ import annotations

import os
import warnings
from contextlib import contextmanager
from typing import Iterator

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
