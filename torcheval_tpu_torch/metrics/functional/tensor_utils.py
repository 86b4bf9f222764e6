"""Shared numeric helpers for functional metrics.

Counterpart of ``torcheval_tpu/metrics/functional/tensor_utils.py``:
``nan_safe_divide``, ``argmax_last`` and ``correct_mask`` with the JAX
package's pinned semantics -- first index on ties, NaN wins, -0.0 ties
with +0.0, and a target outside ``[0, C)`` never matches -- plus
``valid_mask``, the curve integrals and the threshold grids of the binned
metrics. ``segment_sum`` lives in ``ops/segment.py`` and is re-exported
here.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Optional, Union

import numpy as np
import torch

from torcheval_tpu_torch.ops.segment import segment_sum  # noqa: F401  (re-export)

_INT32_MAX = 0x7FFFFFFF


def nan_safe_divide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a / b`` yielding NaN (not inf) where ``b == 0``."""
    zero = b == 0
    return torch.where(
        zero,
        torch.full_like(a, float("nan")),
        a / torch.where(zero, torch.ones_like(b), b),
    )


def _order_key(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving int32 key of a float32 tensor: negative floats
    (descending bit patterns) map below positives, -0.0 maps to +0.0's
    key, and every NaN (either sign) maps to the maximum."""
    xi = x.view(torch.int32)
    # for xi < 0, xi ^ 0x7FFFFFFF == INT32_MIN - 1 - xi (the JAX key),
    # computed without an intermediate that leaves int32
    key = torch.where(xi < 0, xi ^ _INT32_MAX, xi)
    key = torch.where(key == -1, torch.zeros_like(key), key)
    return torch.where(x != x, torch.full_like(key, _INT32_MAX), key)


def argmax_last(x: torch.Tensor) -> torch.Tensor:
    """``argmax`` over the last axis with the JAX package's semantics
    (first index on ties, NaN wins, -0.0 == +0.0): the integer max of the
    order key, then the first index that reaches it, as its
    ``_argmax_last_xla`` computes it (int64 result)."""
    c = x.shape[-1]
    if x.dtype in (torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool):
        key = x.to(torch.int32)
    elif x.dtype in (torch.float32, torch.bfloat16, torch.float16):
        key = _order_key(x.to(torch.float32))
    else:  # int64/float64: an int32 key would reorder -- use the stock op
        return torch.argmax(x, dim=-1)
    mx = key.amax(dim=-1, keepdim=True)
    idx = torch.arange(c, device=x.device)
    return torch.where(key == mx, idx, c).amin(dim=-1)


def correct_mask(x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-row ``(argmax_last(x) == target)`` as float32. A target
    outside ``[0, C)`` can never equal an argmax, so it never matches."""
    return (argmax_last(x) == target).to(torch.float32)


def valid_mask(n: int, valid, dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """Length-``n`` mask with ``valid`` leading ones (the shape-bucketing
    validity row of the masked kernel twins). ``valid`` may be a Python
    int or a tensor count, which is compared on its own device and never
    read back to the host, so a CUDA graph replays it with any count."""
    if device is None and isinstance(valid, torch.Tensor):
        device = valid.device
    return (torch.arange(n, device=device) < valid).to(dtype)


def riemann_integral(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Left-Riemann integral of y(x) over the last axis,
    ``-sum((x[1:] - x[:-1]) * y[:-1])`` (descending-x convention)."""
    return -torch.sum((x[..., 1:] - x[..., :-1]) * y[..., :-1], dim=-1)


def check_reducible(x: torch.Tensor, op: str) -> None:
    """Raise as numpy and the JAX package do when ``op`` ("max" or "min")
    would reduce an empty tensor, which has no identity (torch raises a
    RuntimeError instead). Reads only the shape."""
    if x.numel() == 0:
        raise ValueError(f"zero-size array to reduction operation {op} which has no identity")


def xla_mean(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mean`` as XLA compiles it: the sum times the float32
    reciprocal of the element count (it rewrites a divide by a constant),
    which can differ from torch's ``mean`` in the last bit."""
    n = np.float32(x.numel())
    return torch.sum(x) * float(np.float32(1) / n if n else np.float32(np.inf))


def trapezoid(y: torch.Tensor, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Trapezoidal rule along ``dim``, as the JAX package writes it:
    ``sum(dx * (y[1:] + y[:-1]) / 2)``."""
    x = torch.movedim(x, dim, -1)
    y = torch.movedim(y, dim, -1)
    dx = x[..., 1:] - x[..., :-1]
    return torch.sum(dx * (y[..., 1:] + y[..., :-1]) / 2.0, dim=-1)


@lru_cache(maxsize=64)
def _cached_linspace_grid(n: int) -> np.ndarray:
    """``jnp.linspace(0.0, 1.0, n)`` bit for bit, as a read-only float32
    numpy array: XLA folds its ``iota / (n - 1)`` into a multiply by the
    float32 reciprocal, and the endpoint is exactly 1."""
    if n <= 1:
        grid = np.zeros((max(n, 0),), dtype=np.float32)
    else:
        step = np.float32(1.0) / np.float32(n - 1)
        grid = np.append(np.arange(n - 1, dtype=np.float32) * step, np.float32(1.0))
    grid.setflags(write=False)
    return grid


def create_threshold_tensor(
    threshold: Union[int, List[float], torch.Tensor, np.ndarray],
    *,
    span: bool = False,
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """int n -> ``linspace(0, 1, n)``; a list or tensor -> float32
    thresholds on ``device``.

    The checks (1-D, sorted, values in [0, 1]; with ``span=True`` also
    first value 0 and last value 1, the AUPRC family's rule) run on the
    host before the grid goes to the device, as in the JAX package."""
    if isinstance(threshold, int):
        if span and threshold < 2:
            raise ValueError("Last value in `threshold` should be 1.")
        return torch.from_numpy(_cached_linspace_grid(threshold).copy()).to(device)
    if isinstance(threshold, torch.Tensor):
        t = threshold.detach().cpu().to(torch.float32).numpy()  # tev: disable=host-sync -- the threshold grid is configuration, validated on the host before it goes to the device (once at construction for the classes), as in the JAX package; no metric state is read
    else:
        t = np.asarray(threshold, dtype=np.float32)  # tev: disable=host-sync -- a list of Python floats: no device data
    if t.ndim != 1:
        raise ValueError(
            "The `threshold` should be a one-dimensional tensor, got shape "
            f"{t.shape}."
        )
    if (np.diff(t) < 0.0).any():
        raise ValueError("The `threshold` should be a sorted tensor.")
    if (t < 0.0).any() or (t > 1.0).any():
        raise ValueError("The values in `threshold` should be in the range of [0, 1].")
    if span:
        if t[0] != 0.0:
            raise ValueError("First value in `threshold` should be 0.")
        if t[-1] != 1.0:
            raise ValueError("Last value in `threshold` should be 1.")
    return torch.from_numpy(np.array(t, dtype=np.float32)).to(device)  # tev: disable=host-sync -- copies a host array that is already numpy


def searchsorted_right(sorted_values: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``jnp.searchsorted(sorted_values, x, side="right")`` over float32
    values, with JAX's sort comparator: -0.0 ties +0.0 and a NaN of either
    sign sorts above +inf (so it lands past every threshold). The search
    runs on the integer order keys, so neither the device's float compare
    nor its NaN handling can change a result (int64 positions)."""
    return torch.searchsorted(
        _order_key(sorted_values.to(torch.float32)),
        _order_key(x.to(torch.float32)),
        right=True,
    )
