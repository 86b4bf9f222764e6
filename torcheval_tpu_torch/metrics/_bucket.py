"""Power-of-two shape bucketing for variable-batch metric updates.

Counterpart of ``torcheval_tpu/metrics/_bucket.py``. A ragged stream (a
short last batch, variable-length token batches) gives every update a new
input shape. With ``config.shape_bucketing()`` on, labelled batch axes are
padded up to power-of-two buckets (at least ``MIN_BUCKET``) and a
mask-aware twin of the kernel receives one extra trailing argument, the
int32 vector of valid extents, so padded rows contribute exactly zero to
every state and the whole stream sees at most
``bucket_bound(max_batch)`` shapes per labelled axis. On CUDA
``metrics/_fuse.py`` captures one CUDA graph per bucket and replays it.

Mechanics, as in the JAX package:

- a bucket-aware metric's ``_update_plan`` returns an ``UpdatePlan`` with
  ``masked_kernel`` set and ``batch_axes`` naming the ragged axes of each
  dynamic argument: a tuple of dim labels per argument, positional from
  axis 0, empty or ``None`` for an argument with no ragged axis (a
  threshold grid). Arguments sharing a label must agree on its size;
- :func:`apply_bucketing` pads every labelled axis with zeros (the masked
  twins multiply by the mask, so a NaN or non-zero tail would leak) and
  swaps in the masked kernel, even for a batch whose size is already a
  bucket, so each bucket has one kernel;
- the valid vector lists each label's size in order of first appearance.
  It is made on the metric's device without a host round trip: its values
  come from shapes, which the host knows.

The input sketches' fold (``obs/sketch.py``) and every quality-watched
plan (``obs/quality.py``) carry masked twins too: they turn the valid
vector into per-element weights, so padded rows add nothing to a sketch.

:func:`apply_bucketing` hands out :class:`Padded` and :class:`ValidSizes`
placeholders, not tensors: the CUDA-graph path copies them into its
static input buffers, and an eager run turns them into tensors
(:func:`materialize`; a pad is made once, however many plans share it).
:func:`bucket_shapes` is the one reading of a plan's label sizes and
buckets, for the rewrite here and for the program verifier
(``analysis/program.py``).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from torcheval_tpu_torch import config
from torcheval_tpu_torch.obs import trace as _obs_trace
from torcheval_tpu_torch.obs.recorder import RECORDER as _OBS

# Floor for bucket sizes: tiny ragged tails (1..8 rows) share one bucket
# instead of making buckets 1, 2, 4 and 8.
MIN_BUCKET = 8


def bucket_length(n: int, min_bucket: int = MIN_BUCKET) -> int:
    """Smallest power of two >= ``n`` (floored at ``min_bucket``)."""
    if n <= min_bucket:
        return min_bucket
    return 1 << (int(n) - 1).bit_length()


def bucket_bound(max_n: int, min_bucket: int = MIN_BUCKET) -> int:
    """Most distinct buckets a stream of sizes in [1, max_n] can produce."""
    lo = bucket_length(1, min_bucket)
    hi = bucket_length(max_n, min_bucket)
    return (hi.bit_length() - lo.bit_length()) + 1


def _zeros_like_shape(source: torch.Tensor, shape: tuple) -> torch.Tensor:
    return torch.zeros(shape, dtype=source.dtype, device=source.device)


class Padded:
    """``source`` zero-padded to ``shape`` (every axis at least its
    source size), not yet materialized."""

    __slots__ = ("source", "shape", "_out")

    def __init__(self, source: torch.Tensor, shape: tuple) -> None:
        self.source = source
        self.shape = tuple(shape)
        self._out: Optional[torch.Tensor] = None

    def materialize(self) -> torch.Tensor:
        """The padded tensor (made once, shared by every plan holding
        this placeholder)."""
        if self._out is None:
            if tuple(self.source.shape) == self.shape:
                self._out = self.source
            else:
                out = _zeros_like_shape(self.source, self.shape)
                out[tuple(slice(0, s) for s in self.source.shape)] = self.source
                self._out = out
        return self._out


class ValidSizes:
    """The int32 valid-extent vector of one bucketed update, not yet
    materialized. ``bucket`` is the update's largest bucket length: a
    graph captured for it is attributed to that bucket."""

    __slots__ = ("sizes", "device", "bucket", "_out")

    def __init__(self, sizes: Tuple[int, ...], device: torch.device, bucket: int = 0) -> None:
        self.sizes = tuple(int(n) for n in sizes)
        self.device = device
        self.bucket = int(bucket)
        self._out: Optional[torch.Tensor] = None

    def fill(self, out: torch.Tensor) -> torch.Tensor:
        """Write the sizes into ``out`` (int32, one slot a size) with one
        fill a slot: no host-to-device copy, so no host sync."""
        for i, n in enumerate(self.sizes):
            out[i : i + 1].fill_(n)
        return out

    def materialize(self) -> torch.Tensor:
        if self._out is None:
            if self.device.type == "cpu":
                self._out = torch.tensor(self.sizes, dtype=torch.int32)
            else:
                self._out = self.fill(
                    torch.empty(len(self.sizes), dtype=torch.int32, device=self.device)
                )
        return self._out


def materialize(arg: Any) -> Any:
    """A placeholder of this module as its tensor; anything else as is."""
    if isinstance(arg, (Padded, ValidSizes)):
        return arg.materialize()
    return arg


def _pad_to(arg: torch.Tensor, target_shape: tuple, cache: Optional[Dict]) -> Padded:
    # the cached entry holds the SOURCE tensor too: the id() key is only
    # valid while the source is alive, and the caller may drop its own
    # reference (update_collection discards pre-bucket plans) -- without
    # the pin, id reuse could serve another argument's pad
    key = (id(arg), target_shape)
    if cache is not None and key in cache:
        return cache[key][1]
    out = Padded(arg, target_shape)
    if cache is not None:
        cache[key] = (arg, out)
    return out


class BucketShapes(NamedTuple):
    """What bucketing makes of one plan's dynamic arguments."""

    extents: Tuple[int, ...]  # each label's size, in order of first appearance
    shapes: tuple  # an argument's bucket shape, or None (no ragged axis)
    bucket: int  # the largest bucket length
    device: torch.device  # the first labelled argument's (the CPU without one)


def bucket_shapes(plan) -> BucketShapes:
    """The label sizes of a bucket-aware plan, their order and buckets,
    and each argument's padded shape. Raises ``ValueError`` when
    arguments sharing a label disagree on its size."""
    sizes: Dict[str, int] = {}
    device = None
    for arg, labels in zip(plan.dynamic, plan.batch_axes):
        for axis, label in enumerate(labels or ()):
            n = int(arg.shape[axis])
            device = arg.device if device is None else device
            if sizes.setdefault(label, n) != n:
                raise ValueError(
                    f"Bucketed axis {label!r} has inconsistent sizes "
                    f"{sizes[label]} and {n} across update arguments."
                )
    buckets = {label: bucket_length(n) for label, n in sizes.items()}
    shapes = tuple(
        tuple(buckets[labels[a]] if a < len(labels) else n for a, n in enumerate(arg.shape))
        if labels else None
        for arg, labels in zip(plan.dynamic, plan.batch_axes)
    )
    return BucketShapes(
        tuple(sizes.values()),
        shapes,
        max(buckets.values(), default=0),
        torch.device("cpu") if device is None else device,
    )


def apply_bucketing(plan, pad_cache: Optional[Dict] = None):
    """Rewrite one ``UpdatePlan`` for its shape bucket (no-op when
    bucketing is off or the plan declares no masked kernel): every
    labelled argument becomes a :class:`Padded`, padded or not, and a
    :class:`ValidSizes` is appended.

    ``pad_cache`` lets ``update_collection`` pad a batch shared by many
    metrics once (and share one valid vector among plans with the same
    extents); it must not outlive the call that created it (keys are
    ``id()``-based).
    """
    if (
        not config.shape_bucketing_enabled()
        or plan.masked_kernel is None
        or not plan.batch_axes
    ):
        return plan
    shapes = bucket_shapes(plan)
    padded = tuple(
        arg if shape is None else _pad_to(arg, shape, pad_cache)
        for arg, shape in zip(plan.dynamic, shapes.shapes)
    )

    # Causal attribution (obs/trace.py), recorder on only: stamp the
    # bucket length onto the current span frame (the update wrapper's),
    # as the JAX package does. Only on the single-metric path: in
    # update_collection the open frame is the panel's, and a capture there
    # names its bucket through the valid vector instead.
    if pad_cache is None and _OBS.enabled:
        _obs_trace.annotate(bucket=shapes.bucket)

    # Always dispatch the masked kernel -- even for exactly-bucket-sized
    # batches -- so each bucket owns ONE kernel (and one CUDA graph).
    valid_key = ("valid", shapes.extents)
    valid = pad_cache.get(valid_key) if pad_cache is not None else None
    if valid is None:
        valid = ValidSizes(shapes.extents, shapes.device, shapes.bucket)
        if pad_cache is not None:
            pad_cache[valid_key] = valid
    return plan._replace(
        kernel=plan.masked_kernel,
        dynamic=padded + (valid,),
        masked_kernel=None,
        batch_axes=(),
    )
