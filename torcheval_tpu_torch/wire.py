"""Quantized wire ladder: the ``exact | bf16 | int8`` payload codecs.

Counterpart of ``torcheval_tpu/wire.py``. Every sync tier ships metric
state over some wire: the eager packed protocol (``metrics.synclib``), the
in-step collectives (``metrics.sharded``) and the cross-region federation
(``federation.py``). This module is the one place that knows how a float
payload is narrowed for that wire, as a three-rung ladder:

- ``"exact"``: raw bytes, bit-exact (the default);
- ``"bf16"``: a dense bfloat16 cast, about 2x fewer bytes;
- ``"int8"``: blockwise int8 against a float32 scale a block
  (``scale = amax(block) * float32(1/127)``), about 3.6x fewer bytes at the
  default 32-element block, with a hard per-element error bound of
  ``amax(block) / 254``.

Integer payloads never quantize, so integer counter states are bit-exact
at every rung. Rungs are chosen per family (metric class name) by
``config.wire_ladder()``; the process-wide :data:`LADDER` then caps each
family's rung from measured evidence: a ``DriftSpec`` breach
(``obs/quality.py``) calls :func:`note_budget_breach`, which steps the
family one rung toward ``exact`` and records a ``WireTierEvent``.

The numpy codec is the eager and federation wire. The torch twins
(``quantize_blockwise_jit``, ``pack_wire``, ``unpack_wire``) run on the
metric's device inside the in-step sync, so one uint8 collective replaces
one float collective. Both codecs give the same bytes as the JAX package's
for the same input: the scale is a multiply by the float32 constant
``1/127`` (never a divide by 127), the quotient is a true division,
rounding is half to even, and non-finite elements go to the ``-128``
sentinel (numpy, with an exact float32 side list) or to 0 (the twins, as
the JAX package's traced twin does: a tensor's shape cannot depend on the
non-finite count).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "RUNGS",
    "LADDER",
    "WireLadder",
    "dequantize_blockwise",
    "effective_rung",
    "int8_error_bound",
    "int8_wire_bytes",
    "note_budget_breach",
    "quantize_blockwise",
    "rung_index",
]

# least -> most lossy; "falling back up the ladder" means moving left
RUNGS: Tuple[str, ...] = ("exact", "bf16", "int8")

_RUNG_INDEX = {rung: i for i, rung in enumerate(RUNGS)}
_RUNG_INDEX["off"] = 0  # the legacy config.sync_compression spelling


def rung_index(rung: str) -> int:
    """Ladder position (0 = exact, higher = lossier); accepts ``"off"``."""
    try:
        return _RUNG_INDEX[rung]
    except KeyError:
        raise ValueError(f"unknown wire rung {rung!r}; expected one of {RUNGS}") from None


def normalize_rung(rung: str) -> str:
    """Canonical rung name (``"off"`` -> ``"exact"``)."""
    return RUNGS[rung_index(rung)]


# ------------------------------------------------------------ int8 codec

def _nblocks(size: int, block: int) -> int:
    return -(-max(int(size), 1) // int(block))


def int8_wire_bytes(size: int, block: int) -> int:
    """Wire bytes of the int8 rung for ``size`` elements: an int8 each
    (padded to whole blocks) plus a float32 scale a block."""
    nb = _nblocks(size, block)
    return nb * int(block) + 4 * nb


# the scale is a MULTIPLY by this float32 constant: one IEEE multiply is
# the same bits in numpy, torch and XLA, a divide by 127 is not
_RECIP127 = np.float32(1.0 / 127.0)


def _padded_blocks(a: np.ndarray, block: int) -> np.ndarray:
    flat = np.ascontiguousarray(a, dtype=np.float32).reshape(-1)
    nb = _nblocks(flat.size, block)
    padded = np.zeros(nb * block, dtype=np.float32)
    padded[: flat.size] = flat
    return padded.reshape(nb, block)


def quantize_blockwise(a: np.ndarray, block: int) -> Tuple[np.ndarray, np.ndarray]:
    """Blockwise int8 quantization of a float array (numpy, the eager
    wire). Returns ``(q, scales)``: ``q`` int8 of ``nblocks * block``
    elements (the input flattened and zero-padded to whole blocks) and
    ``scales`` float32 of ``nblocks`` (0 for an all-zero block).
    Dequantization is ``q * scale``, off by at most ``amax / 254``.

    Codes live on ``[-127, 127]``; ``-128`` marks a non-finite element,
    which is left out of its block's amax, and whose exact value travels
    in the side list of :func:`nonfinite_exceptions`."""
    block = int(block)
    blocks = _padded_blocks(a, block)
    finite = np.isfinite(blocks)
    amax = np.abs(np.where(finite, blocks, 0.0)).max(axis=1)
    scales = (amax * _RECIP127).astype(np.float32)
    safe = np.where(scales > 0, scales, np.float32(1.0))
    ratio = np.round(np.where(finite, blocks, 0.0) / safe[:, None])
    q = np.clip(ratio, -127, 127).astype(np.int8)
    q = np.where(finite, q, np.int8(-128))
    return q.reshape(-1), scales


def nonfinite_exceptions(a: np.ndarray) -> np.ndarray:
    """The scan-order float32 side list of ``a``'s non-finite elements
    (the ones :func:`quantize_blockwise` marked ``-128``)."""
    flat = np.ascontiguousarray(a, dtype=np.float32).reshape(-1)
    return flat[~np.isfinite(flat)]


def dequantize_blockwise(
    q: np.ndarray,
    scales: np.ndarray,
    size: int,
    dtype: Any = np.float32,
    exceptions: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Inverse of :func:`quantize_blockwise`: the first ``size`` elements,
    flat, as ``dtype``. ``exceptions`` splices the exact non-finite values
    back at the ``-128`` sentinels (without it they read NaN)."""
    nb = int(scales.size)
    block = q.size // nb if nb else 0
    out = (
        q.reshape(nb, block).astype(np.float32) * scales.astype(np.float32)[:, None]
    ).reshape(-1)[: int(size)]
    sentinel = np.asarray(q).reshape(-1)[: int(size)] == -128
    if sentinel.any():
        out[sentinel] = (
            np.asarray(exceptions, dtype=np.float32)
            if exceptions is not None and np.size(exceptions)
            else np.float32(np.nan)
        )
    return out.astype(dtype)


def int8_error_bound(a: np.ndarray, block: int) -> float:
    """The codec's max-abs-error bound for ``a``: the largest per-block
    ``amax / 254`` over the finite elements."""
    flat = np.ascontiguousarray(a, dtype=np.float32).reshape(-1)
    if flat.size == 0:
        return 0.0
    blocks = _padded_blocks(flat, int(block))
    amax = np.abs(np.where(np.isfinite(blocks), blocks, 0.0)).max(axis=1)
    return float(np.float64(amax.max()) / 254.0)


# ------------------------------------------------------ device twins (torch)

def quantize_blockwise_jit(x: torch.Tensor, block: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The torch twin of :func:`quantize_blockwise`, on ``x``'s device
    (the JAX package's traced twin of the same name). Returns ``(q int8
    [nblocks * block], scales float32 [nblocks])``. A non-finite element
    quantizes to 0 and is left out of its block's amax: the in-step tier
    ships valid prefixes, whose elements are finite."""
    block = int(block)
    flat = x.reshape(-1).to(torch.float32)
    nb = _nblocks(flat.numel(), block)
    blocks = torch.nn.functional.pad(flat, (0, nb * block - flat.numel())).reshape(nb, block)
    finite = torch.isfinite(blocks)
    kept = torch.where(finite, blocks, torch.zeros((), dtype=torch.float32, device=x.device))
    amax = kept.abs().amax(dim=1)
    scales = amax * torch.tensor(_RECIP127, dtype=torch.float32, device=x.device)
    safe = torch.where(scales > 0, scales, torch.ones((), dtype=torch.float32, device=x.device))
    ratio = torch.round(kept / safe[:, None])
    q = ratio.clamp_(-127, 127).to(torch.int8)
    return q.reshape(-1), scales


def pack_wire(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Bit-pack ``(q int8 [n], scales float32 [nb])`` into one flat uint8
    tensor of ``n + 4 * nb`` bytes: the one-collective wire layout."""
    return torch.cat([q.reshape(-1).view(torch.uint8), scales.reshape(-1).view(torch.uint8)])


def unpack_wire(wire: torch.Tensor, nblocks: int, block: int) -> torch.Tensor:
    """Inverse of :func:`pack_wire` for one rank's row: the dequantized
    flat float32 tensor of ``nblocks * block`` elements."""
    nb, block = int(nblocks), int(block)
    n = nb * block
    q = wire[:n].view(torch.int8)
    # a copy puts the scales' bytes at offset 0, where a float32 view may start
    scales = wire[n : n + 4 * nb].clone().view(torch.float32)
    return (q.to(torch.float32).reshape(nb, block) * scales[:, None]).reshape(-1)


# -------------------------------------------------- the fallback registry

class WireLadder:
    """Process-wide per-family effective-rung registry.

    The configured rung comes from ``config.wire_ladder()``; this registry
    holds the cap a drift-budget breach imposes on top of it, and a family
    rides the less lossy of the two. Thread-safe: syncs read while the
    monitor's check writes."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._caps: Dict[str, int] = {}  # tev: guarded-by=_lock

    def effective_rung(self, family: str, configured: str) -> str:
        ci = rung_index(configured)
        with self._lock:
            cap = self._caps.get(family, len(RUNGS) - 1)
        return RUNGS[min(ci, cap)]

    def cap(self, family: str) -> Optional[str]:
        """The family's breach-imposed cap (None: never breached)."""
        with self._lock:
            idx = self._caps.get(family)
        return None if idx is None else RUNGS[idx]

    def note_budget_breach(
        self, family: str, *, series: str = "", breach: str = ""
    ) -> Optional[Tuple[str, str]]:
        """A measured error budget was breached for ``family``: step its
        rung one toward ``exact`` and record a ``WireTierEvent``. Returns
        ``(from_rung, to_rung)``, or None when already exact (no event)."""
        from torcheval_tpu_torch import config
        from torcheval_tpu_torch.obs.events import WireTierEvent
        from torcheval_tpu_torch.obs.recorder import RECORDER

        configured = config.wire_rung_for(family)
        with self._lock:
            cur = min(rung_index(configured), self._caps.get(family, len(RUNGS) - 1))
            if cur <= 0:
                return None
            self._caps[family] = cur - 1
        prev_rung, new_rung = RUNGS[cur], RUNGS[cur - 1]
        RECORDER.record(
            WireTierEvent(
                family=family, series=series, prev_tier=prev_rung, tier=new_rung, breach=breach
            )
        )
        return prev_rung, new_rung

    def reset(self, family: Optional[str] = None) -> None:
        """Lift the cap of ``family`` (or of every family)."""
        with self._lock:
            if family is None:
                self._caps.clear()
            else:
                self._caps.pop(family, None)

    def counters(self) -> Dict[str, Any]:
        """The ``wire`` counter source: the configured default rung, the
        block size and every breach-imposed cap."""
        from torcheval_tpu_torch import config

        with self._lock:
            caps = dict(self._caps)
        out: Dict[str, Any] = {
            "default_rung": config.wire_rung_for("*"),
            "block_size": config.wire_block_size(),
            "fallback_families": len(caps),
        }
        for family, idx in sorted(caps.items()):
            out[f"cap_{family}"] = RUNGS[idx]
        return out


LADDER = WireLadder()


def effective_rung(family: str) -> str:
    """The rung ``family`` rides now: its configured rung capped by any
    drift-breach fallback."""
    from torcheval_tpu_torch import config

    return LADDER.effective_rung(family, config.wire_rung_for(family))


def note_budget_breach(
    family: str, *, series: str = "", breach: str = ""
) -> Optional[Tuple[str, str]]:
    """:meth:`WireLadder.note_budget_breach` on the process-wide
    :data:`LADDER`."""
    return LADDER.note_budget_breach(family, series=series, breach=breach)
