"""Deterministic overload generator: seeded spike schedules for tests
and benchmarks of the table admission layer (a copy of
``torcheval_tpu/utils/test_utils/overload.py``, numpy only, so both
packages draw the same traffic from one seed).

An :class:`OverloadSchedule` is a scripted sequence of load phases —
``ramp`` / ``burst`` / ``sustained`` — each scaling the baseline batch
size (QPS) and key cardinality by a multiplier. Like
:class:`~torcheval_tpu_torch.utils.test_utils.fault_injection.FaultInjectionGroup`,
nothing about the generated traffic depends on wall-clock or iteration
order: every batch is a pure function of ``(seed, step)`` (a fresh
``numpy`` generator per step), so a failing overload scenario replays
bit-identically from its seed alone, any single step can be regenerated
in isolation, and N thread-world ranks calling :meth:`batch` for the
same step synthesize the SAME traffic — which is what lets the
bit-identical-shed-decision tests compare admission across world sizes
without shipping arrays around.

The per-step key draw is uniform over a step-scaled key space: a
``cardinality`` multiplier widens the space, modeling the long-tail
blowup (new tenants / exploration traffic) that actually exhausts a
keyed table, while the QPS multiplier widens the batch. Payload columns
are synthesized per family (``ctr`` / ``weighted_calibration`` /
``ne`` / ``windowed_ne`` / ``hit_rate``) so one schedule can drive a
single-family table or every member of a
:class:`~torcheval_tpu_torch.table.TablePanel`.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, NamedTuple, Sequence, Tuple

import numpy as np

__all__ = ["OverloadBatch", "OverloadPhase", "OverloadSchedule"]

_KINDS = ("ramp", "burst", "sustained")


class OverloadPhase(NamedTuple):
    """One scripted load phase.

    Args:
        kind: ``"ramp"`` (multiplier climbs 1 -> ``peak`` across the
            phase), ``"burst"`` (alternates ``peak`` / baseline every
            ``period`` steps, starting hot), or ``"sustained"`` (holds
            ``peak`` for the whole phase).
        steps: number of ingest steps in the phase.
        peak: QPS multiplier at the top of the phase (>= 1.0 for
            overload; < 1.0 models a lull).
        cardinality: key-cardinality multiplier applied with the same
            shape as the QPS multiplier (1.0 = key space stays at
            baseline even under the spike).
        period: burst on/off half-period in steps (``burst`` only).
    """

    kind: str
    steps: int
    peak: float
    cardinality: float = 1.0
    period: int = 4


class OverloadBatch(NamedTuple):
    """One synthesized ingest batch: pass ``keys`` positionally and
    ``kwargs`` by keyword to ``MetricTable.ingest`` (or one member
    bundle of a panel ingest)."""

    step: int
    keys: np.ndarray
    kwargs: Dict[str, Any]
    qps_multiplier: float
    cardinality_multiplier: float


def _phase_multipliers(phase: OverloadPhase) -> Iterator[Tuple[float, float]]:
    if phase.steps < 1:
        raise ValueError(f"phase steps must be >= 1, got {phase.steps}")
    if phase.kind not in _KINDS:
        raise ValueError(
            f"unknown overload phase kind {phase.kind!r}; one of {_KINDS}"
        )
    for i in range(phase.steps):
        if phase.kind == "ramp":
            frac = i / max(1, phase.steps - 1)
        elif phase.kind == "burst":
            if phase.period < 1:
                raise ValueError(
                    f"burst period must be >= 1, got {phase.period}"
                )
            frac = 1.0 if (i // phase.period) % 2 == 0 else 0.0
        else:  # sustained
            frac = 1.0
        yield (
            1.0 + frac * (phase.peak - 1.0),
            1.0 + frac * (phase.cardinality - 1.0),
        )


class OverloadSchedule:
    """A scripted, seeded load schedule (module docstring).

    Args:
        phases: the scripted :class:`OverloadPhase` sequence.
        base_rows: baseline batch size at multiplier 1.0.
        base_keys: baseline key-space size at cardinality 1.0.
        seed: replay seed; every batch is a pure function of
            ``(seed, step)``.
        family: payload family synthesized by :meth:`batch` /
            :meth:`batches` (``ctr`` | ``weighted_calibration`` |
            ``ne`` | ``windowed_ne`` | ``hit_rate``).
    """

    def __init__(
        self,
        phases: Sequence[OverloadPhase],
        *,
        base_rows: int = 64,
        base_keys: int = 32,
        seed: int = 0,
        family: str = "ctr",
    ) -> None:
        phases = [
            p if isinstance(p, OverloadPhase) else OverloadPhase(*p)
            for p in phases
        ]
        if not phases:
            raise ValueError("an OverloadSchedule needs at least one phase")
        if base_rows < 1 or base_keys < 1:
            raise ValueError(
                f"base_rows/base_keys must be >= 1, got "
                f"{base_rows}/{base_keys}"
            )
        self.phases = tuple(phases)
        self.base_rows = int(base_rows)
        self.base_keys = int(base_keys)
        self.seed = int(seed)
        self.family = str(family)
        self._multipliers: Tuple[Tuple[float, float], ...] = tuple(
            m for p in self.phases for m in _phase_multipliers(p)
        )

    # ------------------------------------------------------------ shapes

    @classmethod
    def ramp(cls, steps: int, peak: float, **kwargs: Any) -> "OverloadSchedule":
        """Baseline -> ``peak`` climb over ``steps``."""
        card = float(kwargs.pop("cardinality", 1.0))
        return cls([OverloadPhase("ramp", steps, peak, card)], **kwargs)

    @classmethod
    def burst(
        cls, steps: int, peak: float, period: int = 4, **kwargs: Any
    ) -> "OverloadSchedule":
        """Alternating ``peak`` / baseline every ``period`` steps."""
        card = float(kwargs.pop("cardinality", 1.0))
        return cls(
            [OverloadPhase("burst", steps, peak, card, period)], **kwargs
        )

    @classmethod
    def sustained(
        cls, steps: int, peak: float, **kwargs: Any
    ) -> "OverloadSchedule":
        """``peak`` held for all ``steps``."""
        card = float(kwargs.pop("cardinality", 1.0))
        return cls([OverloadPhase("sustained", steps, peak, card)], **kwargs)

    # ------------------------------------------------------------- steps

    def __len__(self) -> int:
        return len(self._multipliers)

    def multiplier(self, step: int) -> Tuple[float, float]:
        """``(qps_multiplier, cardinality_multiplier)`` at ``step``."""
        return self._multipliers[step]

    def rows_at(self, step: int) -> int:
        return max(1, int(round(self.base_rows * self._multipliers[step][0])))

    def keyspace_at(self, step: int) -> int:
        return max(1, int(round(self.base_keys * self._multipliers[step][1])))

    def _rng(self, step: int) -> np.random.Generator:
        # (seed, step)-keyed generator: any step replays in isolation
        return np.random.default_rng((self.seed, step))

    def batch(self, step: int) -> OverloadBatch:
        """Synthesize the batch for ``step`` — pure in ``(seed, step)``."""
        qps, card = self._multipliers[step]
        n = self.rows_at(step)
        space = self.keyspace_at(step)
        rng = self._rng(step)
        keys = rng.integers(0, space, size=n).astype(np.int64)
        kwargs: Dict[str, Any]
        if self.family == "ctr":
            kwargs = {
                "clicks": rng.integers(0, 2, size=n).astype(np.float32),
                "weights": 1.0,
            }
        elif self.family == "weighted_calibration":
            kwargs = {
                "preds": rng.random(n).astype(np.float32),
                "targets": rng.integers(0, 2, size=n).astype(np.float32),
                "weights": 1.0,
            }
        elif self.family in ("ne", "windowed_ne"):
            kwargs = {
                "preds": np.clip(
                    rng.random(n).astype(np.float32), 0.01, 0.99
                ),
                "targets": rng.integers(0, 2, size=n).astype(np.float32),
                "weights": 1.0,
            }
        elif self.family == "hit_rate":
            kwargs = {
                "scores": rng.random((n, 8)).astype(np.float32),
                "targets": rng.integers(0, 8, size=n).astype(np.int64),
            }
        else:
            raise ValueError(
                f"no synthesized payload for table family {self.family!r}"
            )
        return OverloadBatch(step, keys, kwargs, qps, card)

    def batches(self) -> Iterator[OverloadBatch]:
        """All scripted batches in step order."""
        for step in range(len(self)):
            yield self.batch(step)

    def total_rows(self) -> int:
        return sum(self.rows_at(s) for s in range(len(self)))
