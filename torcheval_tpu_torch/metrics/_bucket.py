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

``apply_bucketing(..., lazy=True)`` hands out :class:`Padded` and
:class:`ValidSizes` placeholders instead of tensors; the CUDA-graph path
copies them into its static input buffers, and :func:`materialize` turns
them into tensors for an eager run.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from torcheval_tpu_torch import config
from torcheval_tpu_torch.metrics.metric import UpdatePlan
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


def _pad_to(arg: torch.Tensor, target_shape: tuple, cache: Optional[Dict], lazy: bool):
    # the cached entry holds the SOURCE tensor too: the id() key is only
    # valid while the source is alive, and the caller may drop its own
    # reference (update_collection discards pre-bucket plans) -- without
    # the pin, id reuse could serve another argument's pad
    key = (id(arg), target_shape, lazy)
    if cache is not None and key in cache:
        return cache[key][1]
    out: Any = Padded(arg, target_shape)
    if not lazy:
        out = out.materialize()
    if cache is not None:
        cache[key] = (arg, out)
    return out


def apply_bucketing(plan, pad_cache: Optional[Dict] = None, *, lazy: bool = False):
    """Rewrite one update plan for its shape bucket (no-op when bucketing
    is off or the plan declares no masked kernel).

    ``pad_cache`` lets ``update_collection`` pad a batch shared by many
    metrics once (and share one valid vector among plans with the same
    extents); it must not outlive the call that created it (keys are
    ``id()``-based). ``lazy=True`` returns :class:`Padded` placeholders for
    every labelled argument, padded or not, and a :class:`ValidSizes`, for
    the CUDA-graph path to copy into its static buffers.
    """
    if (
        not config.shape_bucketing_enabled()
        or not isinstance(plan, UpdatePlan)
        or plan.masked_kernel is None
        or not plan.batch_axes
    ):
        return plan

    sizes: Dict[str, int] = {}
    order = []
    device = None
    for arg, labels in zip(plan.dynamic, plan.batch_axes):
        for axis, label in enumerate(labels or ()):
            n = int(arg.shape[axis])
            device = arg.device if device is None else device
            if label not in sizes:
                sizes[label] = n
                order.append(label)
            elif sizes[label] != n:
                raise ValueError(
                    f"Bucketed axis {label!r} has inconsistent sizes "
                    f"{sizes[label]} and {n} across update arguments."
                )
    if device is None:  # no labelled axis: an empty valid vector
        device = torch.device("cpu")
    buckets = {label: bucket_length(n) for label, n in sizes.items()}

    padded = []
    for arg, labels in zip(plan.dynamic, plan.batch_axes):
        if not labels:
            padded.append(arg)
            continue
        shape = list(arg.shape)
        for axis, label in enumerate(labels):
            shape[axis] = buckets[label]
        if tuple(shape) == tuple(arg.shape) and not lazy:
            padded.append(arg)
        else:
            padded.append(_pad_to(arg, tuple(shape), pad_cache, lazy))

    # Causal attribution (obs/trace.py), recorder on only: stamp the
    # bucket length onto the current span frame (the update wrapper's),
    # as the JAX package does. Only on the single-metric path: in
    # update_collection the open frame is the panel's, and a capture there
    # names its bucket through the valid vector instead.
    bucket = max(buckets.values(), default=0)
    if pad_cache is None and _OBS.enabled:
        _obs_trace.annotate(bucket=bucket)

    # Always dispatch the masked kernel -- even for exactly-bucket-sized
    # batches -- so each bucket owns ONE kernel (and one CUDA graph).
    extents = tuple(sizes[label] for label in order)
    valid_key = ("valid", extents, lazy)
    if pad_cache is not None and valid_key in pad_cache:
        valid = pad_cache[valid_key]
    else:
        valid = ValidSizes(extents, device, bucket)
        if not lazy:
            valid = valid.materialize()
        if pad_cache is not None:
            pad_cache[valid_key] = valid
    return plan._replace(
        kernel=plan.masked_kernel,
        dynamic=tuple(padded) + (valid,),
        masked_kernel=None,
        batch_axes=(),
    )
