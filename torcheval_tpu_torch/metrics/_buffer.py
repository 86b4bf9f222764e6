"""Growable example buffers for the metrics that keep every sample.

Counterpart of ``torcheval_tpu/metrics/_buffer.py`` with the same state
layout, so a buffered metric's ``state_dict`` loads across the packages:

- each buffer is one tensor whose sample axis has a power-of-two capacity,
  at least ``MIN_CAPACITY``;
- slots past the valid count hold the buffer's neutral fill (score
  ``-inf``, weight ``0``, target ``0`` or ``-1``), so the curve
  computations may run over the whole padded buffer: padded entries sort
  last and carry no mass;
- ``_num_samples`` (a Python int, ``MergeKind.CUSTOM``) counts the valid
  samples;
- before the first append every buffer is a 0-size float32 sentinel; the
  first batch fixes its dtype and row shape, 64-bit dtypes narrowed to the
  32-bit ones the JAX package holds (``utils.convert.narrow_dtype``).

An append writes the batch into a narrowed slice of each buffer, in place;
growth allocates a filled buffer of the next capacity and copies the old
one in. ``state_dict`` and ``load_state_dict`` copy (the base class's
rule), so a snapshot never aliases a buffer that a later append writes.
``merge_state`` appends each peer's valid prefix; ``_sync_state_dict``
ships each buffer trimmed to ``next_capacity(count)``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from torcheval_tpu_torch.metrics.metric import MergeKind, Metric, _clone_state
from torcheval_tpu_torch.utils.convert import narrow_dtype

MIN_CAPACITY = 64


def next_capacity(n: int) -> int:
    """Smallest power of two >= n (and >= MIN_CAPACITY)."""
    if n <= MIN_CAPACITY:
        return MIN_CAPACITY
    return 1 << (n - 1).bit_length()


class _BufferSpec(NamedTuple):
    """One buffer's neutral fill and sample axis (may be negative)."""

    fill: float
    axis: int


class BufferedExamplesMetric(Metric[torch.Tensor]):
    """Base for metrics that buffer raw examples across updates.

    Subclasses declare their buffers with :meth:`_add_buffer` (all buffers
    share one sample count) and append with :meth:`_append`. Slots past
    ``_num_samples`` always hold each buffer's neutral fill, so pad-neutral
    computations may take :meth:`_padded`; exact-size ones take
    :meth:`_valid`.
    """

    def __init__(self, *, device=None) -> None:
        super().__init__(device=device)
        self._buffer_specs: Dict[str, _BufferSpec] = {}
        self._add_state("_num_samples", 0, merge=MergeKind.CUSTOM)

    def _add_buffer(self, name: str, *, fill: float, axis: int = -1) -> None:
        self._buffer_specs[name] = _BufferSpec(fill, axis)
        # 0-size sentinel: the first append fixes dtype and row shape
        self._add_state(name, torch.zeros((0,)), merge=MergeKind.CUSTOM)

    # -------------------------------------------------------------- appending

    def _append(self, **batches: torch.Tensor) -> None:
        """Append one batch to every buffer (the same sample count each);
        a batch that does not fit changes nothing."""
        specs = self._buffer_specs
        if set(batches) != set(specs):
            raise ValueError(
                f"expected batches for {sorted(specs)}, got {sorted(batches)}"
            )
        first = next(iter(batches))
        n_new = batches[first].shape[specs[first].axis]
        for name, batch in batches.items():
            if batch.shape[specs[name].axis] != n_new:
                raise ValueError(
                    f"buffer {name!r}: batch sample count "
                    f"{batch.shape[specs[name].axis]} != {n_new}"
                )
        count = self._num_samples
        needed = count + n_new
        grown = {
            name: self._ensure_capacity(getattr(self, name), specs[name], batch, needed)
            for name, batch in batches.items()
        }
        for name, batch in batches.items():
            buf = grown[name]
            buf.narrow(specs[name].axis % buf.ndim, count, n_new).copy_(batch)
            setattr(self, name, buf)
        self._num_samples = needed

    def _ensure_capacity(
        self,
        buf: torch.Tensor,
        spec: _BufferSpec,
        batch: torch.Tensor,
        needed: int,
    ) -> torch.Tensor:
        axis = spec.axis % batch.ndim
        if buf.numel() == 0 and buf.ndim == 1 and self._num_samples == 0:
            # lazy init: row shape and dtype from the first batch
            shape = list(batch.shape)
            shape[axis] = next_capacity(needed)
            return torch.full(
                shape, spec.fill, dtype=narrow_dtype(batch.dtype), device=self.device
            )
        cap = buf.shape[axis]
        if needed <= cap:
            return buf
        shape = list(buf.shape)
        shape[axis] = next_capacity(needed)
        new = torch.full(shape, spec.fill, dtype=buf.dtype, device=buf.device)
        new.narrow(axis, 0, cap).copy_(buf)
        return new

    # ------------------------------------------------------------------ access

    @property
    def num_samples(self) -> int:
        return self._num_samples

    def _padded(self) -> Tuple[torch.Tensor, ...]:
        """Full-capacity buffers (padding = neutral fills), declaration
        order."""
        self._require_data()
        return tuple(getattr(self, name) for name in self._buffer_specs)

    def _valid(self) -> Tuple[torch.Tensor, ...]:
        """Views of the valid samples (declaration order)."""
        self._require_data()
        out = []
        for name, spec in self._buffer_specs.items():
            buf = getattr(self, name)
            out.append(buf.narrow(spec.axis % buf.ndim, 0, self._num_samples))
        return tuple(out)

    def _require_data(self) -> None:
        if self._num_samples == 0:
            raise RuntimeError(
                f"{type(self).__name__} has no data: call update() before "
                "compute()."
            )

    def _valid_mask(self, capacity: int) -> torch.Tensor:
        """(capacity,) bool mask of the valid slots."""
        return torch.arange(capacity, device=self.device) < self._num_samples

    # ------------------------------------------------------------------- sync

    def _sync_state_dict(self):
        """The state a sync ships: each buffer trimmed to the smallest
        power-of-two bucket covering the valid count, never the full
        capacity. The trimmed tail keeps the neutral fill, so a clone
        loaded from it computes as the original does (with a smaller,
        still power-of-two, capacity)."""
        keep = next_capacity(self._num_samples)
        sd = {}
        for name in self._state_name_to_default:
            value = getattr(self, name)
            spec = self._buffer_specs.get(name)
            if spec is not None and value.ndim > 0:
                axis = spec.axis % value.ndim
                if value.shape[axis] > keep:
                    value = value.narrow(axis, 0, keep)
            sd[name] = _clone_state(value)
        return sd

    # ------------------------------------------------------------------ merge

    def merge_state(self, metrics) -> "BufferedExamplesMetric":
        """Append every peer's valid samples to our buffers; any
        non-buffer states merge by their declared kinds."""
        names = list(self._buffer_specs)
        skip = set(names) | {"_num_samples"}
        for other in metrics:
            if other._num_samples > 0:
                # the base append by buffer name: subclasses may override
                # _append with a user-facing (input, target) signature
                BufferedExamplesMetric._append(
                    self,
                    **{n: self._place_state(v) for n, v in zip(names, other._valid())},
                )
            for name, kind in self._state_name_to_merge_kind.items():
                if name in skip:
                    continue
                mine = getattr(self, name)
                theirs = self._place_state(getattr(other, name))
                setattr(self, name, self._merge_one(name, kind, mine, theirs))
        return self

    def _merge_custom_state(self, name, mine, theirs):
        # buffer states merge in merge_state; a direct call keeps ours
        return mine
