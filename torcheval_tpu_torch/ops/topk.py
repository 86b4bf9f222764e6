"""Top-k selection with ``lax.top_k`` semantics.

Counterpart of ``torcheval_tpu/ops/topk.py`` (``topk`` :49). The JAX
package runs ``lax.top_k`` on the TPU and an O(n) selection kernel on the
CPU (``ops/native/topk.cc``); neither is a TPU kernel, so here it is a
plain torch op.

``lax.top_k`` orders descending by IEEE totalOrder -- +NaN first, then
+inf, ..., +0 above -0, ..., -inf, -NaN last -- and breaks ties by
ascending index. ``torch.topk`` is not stable on ties and orders neither
+-0 nor NaN that way, so the selection runs on an int64 key instead: the
value's totalOrder rank in the high 32 bits and the inverted index in the
low 32, so every key is distinct and the largest keys are the ``lax.top_k``
picks, on any device.
"""

from __future__ import annotations

from typing import Tuple

import torch

_INT32_MAX = 0x7FFFFFFF
_LOW_BITS = 1 << 32


def _total_order_key(x: torch.Tensor) -> torch.Tensor:
    """An integer key whose order is IEEE totalOrder of ``x`` (float32 or
    float64 bits: negative values flip their magnitude bits, so -0 sits
    below +0 and a negative NaN below -inf); integers are their own key."""
    if not x.is_floating_point():
        return x.to(torch.int64)
    if x.dtype == torch.float64:
        bits = x.view(torch.int64)
        return torch.where(bits < 0, bits ^ 0x7FFFFFFFFFFFFFFF, bits)
    bits = x.to(torch.float32).view(torch.int32)
    return torch.where(bits < 0, bits ^ _INT32_MAX, bits)


def topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k(x, k)``: ``(values, indices)`` of the ``k`` largest
    entries along the last axis, descending by totalOrder, ties by
    ascending index; indices int32. Differentiable in the values (their
    gradient is scattered back through the picked indices).

    >>> import torch
    >>> from torcheval_tpu_torch.ops import topk
    >>> topk(torch.tensor([0.1, 0.7, 0.4]), 2)
    (tensor([0.7000, 0.4000]), tensor([1, 2], dtype=torch.int32))
    """
    n = x.shape[-1]
    if not 0 <= k <= n:
        raise ValueError(
            f"k must be in [0, {n}] for input shape {tuple(x.shape)}, got {k}."
        )
    key = _total_order_key(x.detach())
    if x.dtype in (torch.int64, torch.float64) or n >= _LOW_BITS:
        # a 64-bit key leaves no room for the index: a stable sort keeps
        # ties in index order
        order = torch.sort(key, dim=-1, descending=True, stable=True).indices[..., :k]
    else:
        inverted = (n - 1) - torch.arange(n, dtype=torch.int64, device=x.device)
        packed = key.to(torch.int64) * _LOW_BITS + inverted
        order = torch.topk(packed, k, dim=-1, sorted=True).indices
    return torch.gather(x, -1, order), order.to(torch.int32)
