"""Shared machinery for windowed metrics (counterpart of
``torcheval_tpu/metrics/window/_base.py``).

Four windowed metrics (CTR, NE, MSE, weighted calibration) keep one
structure: each ``update()`` writes its per-task counters into column
``next_inserted`` of a ``(num_tasks, max_num_updates)`` float32 ring, the
windowed value is built from the ring's row sums, and an optional
lifetime accumulator runs alongside. Unfilled columns are zero, so the
full-row sums equal sums over the valid columns.

In eager PyTorch an update is one transform plan: the counter kernel, the
lifetime adds and an in-place write of ring column ``col`` (a Python int,
so the write is a plain strided copy with no index tensor). The cursor
stays a host int that the plan's ``finalize`` advances after the states
are set. Merge packs every replica's valid columns into an enlarged
buffer, as the reference's concatenating merge does; column order never
matters because every consumer is a sum.

Sharded windows (``shard=ShardContext(rank, world)``, ``metrics/
shardspec.py``): the rings and lifetime vectors partition by TASK rows.
Every rank must observe the SAME update stream (the counters are per task,
not per example); each keeps its owned rows, the plan slices the counter
vectors to them, and the merge places disjoint rows
(``Metric._merge_sharded``), equal to the one metric that saw the stream.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, TypeVar

import torch

from torcheval_tpu_torch.metrics.metric import MergeKind, Metric, UpdatePlan
from torcheval_tpu_torch.metrics.shardspec import ShardSpec

TWindowed = TypeVar("TWindowed", bound="WindowedTaskCounterMetric")


def _window_transform(kernel, n_counters: int, lifetime: bool, row_slice=None):
    """The transform body of one windowed update over the names-ordered
    state tuple ``(lifetime..., rings...)``: ``kernel(*args)`` gives the
    update's counters, which add into the lifetime states and are written
    into ring column ``col`` in place. ``row_slice`` (a sharded window):
    the counters span every task and are cut to this rank's
    ``[start, stop)`` rows first; a 0-d counter broadcasts as before."""

    def transform(states, col, *args):
        deltas = kernel(*args)
        if not isinstance(deltas, tuple):
            deltas = (deltas,)
        if len(deltas) != n_counters:
            raise ValueError(
                f"kernel {kernel.__name__} returned {len(deltas)} "
                f"counter values for {n_counters} counters"
            )
        if row_slice is not None:
            deltas = tuple(d if d.ndim == 0 else d[row_slice[0] : row_slice[1]] for d in deltas)
        if lifetime:
            lt, rings = states[:n_counters], states[n_counters:]
            new_lt = tuple(v + d for v, d in zip(lt, deltas))
        else:
            rings, new_lt = states, ()
        for ring, d in zip(rings, deltas):
            ring[:, col] = d  # a 0-d delta broadcasts over the task rows
        return new_lt + tuple(rings)

    return transform


class RingCursorSerializationMixin:
    """Snapshot/restore of the ring-buffer write cursor.

    The cursor is a plain attribute, not a registered state (as in the
    reference), but a resumed metric must not overwrite the wrong column:
    ``state_dict`` carries it, and ``load_state_dict`` restores it, or
    re-derives it from a snapshot that has none.
    """

    _cursor_attr = "next_inserted"
    _cursor_total_state = "total_updates"
    _cursor_capacity_state = "max_num_updates"

    def state_dict(self):
        snapshot = super().state_dict()
        snapshot[self._cursor_attr] = getattr(self, self._cursor_attr)
        return snapshot

    def load_state_dict(self, state_dict, strict: bool = True) -> None:
        state_dict = dict(state_dict)
        cursor = state_dict.pop(self._cursor_attr, None)
        super().load_state_dict(state_dict, strict=strict)
        if cursor is None:
            # a snapshot without a cursor: exact for any never-merged history
            cursor = getattr(self, self._cursor_total_state) % getattr(
                self, self._cursor_capacity_state
            )
        setattr(self, self._cursor_attr, int(cursor))


class WindowedTaskCounterMetric(RingCursorSerializationMixin, Metric):
    """Base for windowed metrics whose state is per-update counters.

    Subclasses call ``_init_window_states(counter_names, ...)`` in
    ``__init__``, build each update with ``_window_plan`` and ``compute``
    from ``_windowed_counter_sums`` and the lifetime states.
    """

    def _init_window_states(
        self,
        counter_names: Sequence[str],
        *,
        num_tasks: int,
        max_num_updates: int,
        enable_lifetime: bool,
        lifetime_defaults: Optional[Sequence[torch.Tensor]] = None,
    ) -> None:
        if num_tasks < 1:
            raise ValueError(
                "`num_tasks` value should be greater than and equal to 1, "
                f"but received {num_tasks}. "
            )
        if max_num_updates < 1:
            raise ValueError(
                "`max_num_updates` value should be greater than and equal to "
                f"1, but received {max_num_updates}. "
            )
        self.num_tasks = num_tasks
        self.enable_lifetime = enable_lifetime
        self._counter_names = tuple(counter_names)
        self._add_state("max_num_updates", max_num_updates, merge=MergeKind.CUSTOM)
        self.next_inserted = 0
        self._add_state("total_updates", 0, merge=MergeKind.CUSTOM)
        # sharded by task rows under a shard context, ignored without one
        ring_shard = ShardSpec(axis=0)
        if enable_lifetime:
            if lifetime_defaults is None:
                lifetime_defaults = [torch.zeros(num_tasks) for _ in counter_names]
            for name, default in zip(counter_names, lifetime_defaults):
                self._add_state(name, default, merge=MergeKind.CUSTOM, shard=ring_shard)
        for name in counter_names:
            self._add_state(
                f"windowed_{name}",
                torch.zeros((num_tasks, max_num_updates)),
                merge=MergeKind.CUSTOM,
                shard=ring_shard,
            )

    # ------------------------------------------------------------- accumulate

    def _window_plan(self, kernel, dynamic: tuple, config: tuple = ()) -> UpdatePlan:
        """The transform plan of one windowed update: ``kernel(*dynamic,
        *config)`` gives the counters; the lifetime adds and the write of
        ring column ``next_inserted`` follow, and ``finalize`` advances
        the cursor and the update count. Input validation stays with the
        caller."""
        counter_names = self._counter_names
        names = (
            tuple(counter_names) if self.enable_lifetime else ()
        ) + tuple(f"windowed_{n}" for n in counter_names)
        col = self.next_inserted
        row_slice = None
        if self._sharded_states and self._own_shard_active():
            row_slice = self._shard_ctx.shard_range(self.num_tasks)

        def finalize():
            self.next_inserted = (col + 1) % self.max_num_updates
            self.total_updates += 1

        return UpdatePlan(
            _window_transform(kernel, len(counter_names), self.enable_lifetime, row_slice),
            names,
            (col,) + tuple(dynamic),
            tuple(config),
            transform=True,
            finalize=finalize,
        )

    def _windowed_counter_sums(self) -> List[torch.Tensor]:
        """Per-task sums over the window, shape (num_tasks,) each."""
        return [
            torch.sum(getattr(self, f"windowed_{name}"), dim=-1)
            for name in self._counter_names
        ]

    # ------------------------------------------------------------------ merge

    def merge_state(self: TWindowed, metrics: Iterable[TWindowed]) -> TWindowed:
        """Pack every replica's valid window columns into an enlarged
        buffer (the reference's concatenating merge); ``max_num_updates``
        itself is unchanged, so the merged window keeps its size while the
        buffer holds every replica's live columns.

        After a merge the cursor is ``columns packed % max_num_updates``,
        as in the reference, so a later update overwrites that column of
        the enlarged buffer, which need not be the oldest. The JAX package
        keeps this too, and the port's tests pin it against that package.

        A shard carrier reassembles instead (``Metric._merge_sharded``):
        the carriers hold disjoint task rows of one window, so the merge
        places rows rather than concatenating columns.
        """
        metrics = list(metrics)
        if self._sharded_states and self._is_shard_carrier():
            return Metric.merge_state(self, metrics)
        merged_cols = self.max_num_updates + sum(m.max_num_updates for m in metrics)
        cur_size = min(self.total_updates, self.max_num_updates)
        new_bufs = {}
        for name in self._counter_names:
            buf = torch.zeros((self.num_tasks, merged_cols), device=self.device)
            buf[:, :cur_size] = getattr(self, f"windowed_{name}")[:, :cur_size]
            new_bufs[name] = buf
        idx = cur_size
        for m in metrics:
            if self.enable_lifetime:
                for name in self._counter_names:
                    theirs = self._place_state(getattr(m, name))
                    setattr(self, name, getattr(self, name) + theirs)
            size = min(m.total_updates, m.max_num_updates)
            for name in self._counter_names:
                theirs = self._place_state(getattr(m, f"windowed_{name}"))
                new_bufs[name][:, idx : idx + size] = theirs[:, :size]
            idx += size
            self.total_updates += m.total_updates
        for name in self._counter_names:
            setattr(self, f"windowed_{name}", new_bufs[name])
        self.next_inserted = idx % self.max_num_updates
        return self

    # ---------------------------------------------------------------- compute

    def _empty_result(self):
        empty = torch.zeros(0, device=self.device)
        if self.enable_lifetime:
            return empty, empty.clone()
        return empty
