"""Input coercion and state carried across packages.

Every ``update()`` and functional entry point accepts torch tensors, numpy
arrays, Python scalars and sequences, as the JAX package's
``utils/convert.py`` does. numpy float64 inputs narrow to float32, matching
the JAX package's default (x64 disabled) so both packages compute on the
same values; torch tensors keep their dtype.

Within ``shared_conversion_cache()`` (``toolkit.update_collection``
opens one) ``to_torch`` converts each source object once.

``numpy_state_dict`` / ``load_numpy_state_dict`` carry a metric's state
between this package and the JAX package through numpy: the JAX
package's ``state_dict()`` read out as numpy loads here, and the reverse.
"""

from __future__ import annotations

import contextvars
from contextlib import contextmanager
from typing import Any, Dict, Iterator, Optional, Union

import numpy as np
import torch

TensorLike = Any  # torch.Tensor | np.ndarray | scalar | sequence
DeviceLike = Union[torch.device, str, None]

# per-call shared conversion memo (see shared_conversion_cache); None =
# off, the default for a plain metric.update
_CONVERSION_CACHE: "contextvars.ContextVar[Optional[dict]]" = contextvars.ContextVar(
    "torcheval_tpu_torch_conversion_cache", default=None
)


@contextmanager
def shared_conversion_cache() -> Iterator[None]:
    """Scope within which ``to_torch`` memoizes conversions per source
    object and target dtype and device.

    ``toolkit.update_collection`` feeds ONE batch to K metrics; without
    this each metric's ``_input`` would convert (and for a numpy input,
    copy to the card) the same arrays K times. Sharing one converted
    tensor among the K metrics is safe only because no update kernel
    writes its inputs: the kernels read them, and the bucketing pads copy
    them. Keys are ``id``-based with the source pinned in the entry, so
    id reuse after garbage collection cannot alias; the cache must not
    outlive the call that created it.
    """
    token = _CONVERSION_CACHE.set({})
    try:
        yield
    finally:
        _CONVERSION_CACHE.reset(token)


def canonicalize_device(device: DeviceLike) -> torch.device:
    """Resolve ``device`` for a class metric's state.

    ``None`` means CUDA: metric state lives on the card. Without a card
    this raises instead of quietly running on the CPU -- pass
    ``device="cpu"`` to ask for the CPU. A bare ``"cuda"`` resolves to
    the current CUDA device index, so state and inputs compare equal.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "torcheval_tpu_torch metrics keep their state on CUDA by "
                "default, but no CUDA device is available; pass "
                'device="cpu" to run on the CPU.'
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def functional_device(device: DeviceLike, *inputs: Any) -> torch.device:
    """Where a functional entry point runs: an explicit ``device``, else
    the device of its first tensor input, else CUDA (numpy arrays and
    Python scalars go to the card unless ``device="cpu"`` is passed)."""
    if device is not None:
        return canonicalize_device(device)
    for x in inputs:
        if isinstance(x, torch.Tensor):
            return x.device
    return canonicalize_device(None)


def to_torch(
    x: TensorLike,
    *,
    dtype: Optional[torch.dtype] = None,
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """Coerce ``x`` to a tensor on ``device`` (no copy when it is already
    there with the right dtype)."""
    cache = _CONVERSION_CACHE.get()
    if cache is not None:
        key = (id(x), dtype, device)
        hit = cache.get(key)
        if hit is not None and hit[0] is x:
            return hit[1]
        t = _to_torch_impl(x, dtype=dtype, device=device)
        cache[key] = (x, t)  # pin the source: id is only valid while alive
        return t
    return _to_torch_impl(x, dtype=dtype, device=device)


def _to_torch_impl(
    x: TensorLike,
    *,
    dtype: Optional[torch.dtype] = None,
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if (device is None or t.device == device) and (dtype is None or t.dtype == dtype):
            return t  # what .to() would return, without its cost on every update
    else:
        arr = np.asarray(x)
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        elif arr.dtype == object:
            raise TypeError(f"cannot convert {type(x).__name__} to a tensor")
        # ascontiguousarray would turn a 0-d array into shape (1,)
        t = torch.from_numpy(arr if arr.flags.c_contiguous else np.ascontiguousarray(arr))
    return t.to(device=device, dtype=dtype)


# what the JAX package's arrays hold with x64 disabled: its 64-bit inputs
# arrive narrowed to 32 bits
_NARROW_64 = {
    torch.int64: torch.int32,
    torch.float64: torch.float32,
    torch.complex128: torch.complex64,
}


def narrow_dtype(dtype: torch.dtype) -> torch.dtype:
    """A 64-bit dtype narrowed to the 32-bit one the JAX package would hold
    (int64 -> int32, float64 -> float32); other dtypes as they are.
    Buffered example states take their dtype from the first batch, so
    narrowing keeps their dtypes equal across the two packages."""
    return _NARROW_64.get(dtype, dtype)


def narrow_64(t: torch.Tensor) -> torch.Tensor:
    """``t`` in ``narrow_dtype(t.dtype)`` (no copy when that is its own)."""
    dtype = narrow_dtype(t.dtype)
    return t if dtype == t.dtype else t.to(dtype)


def to_torch_float(
    x: TensorLike, *, device: Optional[torch.device] = None
) -> torch.Tensor:
    """``to_torch``, then non-float dtypes promote to float32."""
    t = to_torch(x, device=device)
    if not t.is_floating_point():
        t = t.to(torch.float32)
    return t


def resolve_weight(
    weight: Any, input: torch.Tensor, *, int_clause: bool = False
) -> tuple:
    """Split a ``weight`` argument into the scalar / matching-tensor case:
    ``(is_scalar, weight_tensor)``, the tensor float32 and on ``input``'s
    device (mirrors the JAX package's ``resolve_weight``)."""
    if isinstance(weight, (float, int)) and not isinstance(weight, bool):
        return True, torch.full(
            (), float(weight), dtype=torch.float32, device=input.device
        )
    weight_t = to_torch_float(weight, device=input.device)
    if weight_t.shape == input.shape:
        return False, weight_t
    raise ValueError(
        "Weight must be either a float value or "
        + ("an int value or " if int_clause else "")
        + f"a tensor that matches the input tensor size. Got {weight} instead."
    )


def bfloat16_numpy_dtype() -> np.dtype:
    """numpy's bfloat16: ``ml_dtypes.bfloat16``, the type the JAX package
    reads its bfloat16 arrays out as (imported on first use: only
    bfloat16 states need it)."""
    import ml_dtypes

    return np.dtype(ml_dtypes.bfloat16)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor read out to host numpy. numpy has no bfloat16 of its own,
    so a bfloat16 tensor leaves as an ``ml_dtypes.bfloat16`` array holding
    its 16-bit patterns unchanged: the JAX package's numpy form, so the
    bytes of a sync payload or a checkpoint shard are the same."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(bfloat16_numpy_dtype())
    return t.numpy()


def numpy_to_tensor(a: Any) -> torch.Tensor:
    """Inverse of :func:`tensor_to_numpy`: a host array (copied, so the
    tensor owns its memory) as a CPU tensor; an ``ml_dtypes.bfloat16``
    array comes back as bfloat16 bit for bit."""
    arr = np.array(a, copy=True)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _to_numpy(value: Any) -> Any:
    if isinstance(value, torch.Tensor):
        return tensor_to_numpy(value)
    if isinstance(value, list):
        return [_to_numpy(v) for v in value]
    if isinstance(value, dict):
        return {k: _to_numpy(v) for k, v in value.items()}
    return value


def numpy_state_dict(metric) -> Dict[str, Any]:
    """``metric.state_dict()`` with every tensor read out as numpy --
    the form the JAX package's ``load_state_dict`` takes."""
    return {name: _to_numpy(v) for name, v in metric.state_dict().items()}


def load_numpy_state_dict(metric, state: Dict[str, Any]) -> None:
    """Load ``{name: np.ndarray | list | float | int}`` (for example the
    JAX package's ``state_dict()`` read out as numpy) into ``metric``; a
    list state holds numpy arrays.

    Array states must arrive with the dtype this metric registered -- the
    two packages share state dtypes, so a mismatch means the payload
    belongs to another metric -- and scalar states stay Python numbers. A
    buffered example state (``metrics/_buffer.py``) takes the payload's
    dtype: its dtype is fixed by the first batch, not at registration.
    """
    buffers = getattr(metric, "_buffer_specs", {})
    converted: Dict[str, Any] = {}
    for name, value in state.items():
        current = getattr(metric, name, None)
        if isinstance(current, torch.Tensor):
            t = numpy_to_tensor(value)
            if t.dtype != current.dtype and name not in buffers:
                raise TypeError(
                    f"state {name!r} of {type(metric).__name__} is "
                    f"{current.dtype}, got a {np.asarray(value).dtype} array"
                )
            converted[name] = t
        elif isinstance(value, list):
            # a list state (retrieval precision's per-query buffers): the
            # elements' dtypes come with the data
            converted[name] = [numpy_to_tensor(v) for v in value]
        elif isinstance(value, np.generic):
            converted[name] = value.item()
        elif isinstance(value, np.ndarray) and value.ndim == 0:
            converted[name] = value.item()
        else:
            converted[name] = value
    metric.load_state_dict(converted)
