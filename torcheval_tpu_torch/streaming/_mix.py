"""Deterministic 32-bit n-gram window mixer (counterpart of
``torcheval_tpu/streaming/_mix.py``).

One left-fold hash shared by both n-gram count planes of the streaming
subsystem: the device fold inside ``StreamingNgramOverlap``'s decode-step
update and the host mirror inside ``StreamTable``'s per-request stream
state. The two must agree bit for bit (the keyed table's finals are held
to the standalone metric's counters), so the constants live here once.

The mix is a murmur3-finalizer-style avalanche over each token of the
(<= n)-token window, folded left to right from a fixed seed. Token ids
are non-negative int32 (``-1``, "no token this step", is never hashed).

torch has no general uint32 arithmetic on CUDA, so the device fold holds
each uint32 value in an int64 tensor and multiplies in 16-bit halves
(``obs.sketch._mul32``): a bare int64 product of two 32-bit values can
leave int64.
"""

from __future__ import annotations

from typing import Sequence

import torch

from torcheval_tpu_torch.obs.sketch import _mul32

__all__ = ["MIX_SEED", "mix_fold_int", "mix_seed", "mix_step"]

# golden-ratio odd multiplier + murmur3-finalizer avalanche constant;
# seed is the FNV-1a 32-bit offset basis. All arithmetic is mod 2^32.
_M1 = 0x9E3779B1
_M2 = 0x85EBCA77
MIX_SEED = 0x811C9DC5
_MASK32 = 0xFFFFFFFF


def mix_fold_int(tokens: Sequence[int], seed: int = MIX_SEED) -> int:
    """Host fold: hash a whole token window with Python ints (exact
    uint32 wraparound via masking). Mirror of the device fold below."""
    h = seed & _MASK32
    for tok in tokens:
        h = ((h ^ (int(tok) & _MASK32)) * _M1) & _MASK32
        h ^= h >> 15
        h = (h * _M2) & _MASK32
        h ^= h >> 13
    return h


def mix_seed(device=None) -> torch.Tensor:
    """The fold seed as a 0-d int64 tensor holding a uint32 value."""
    return torch.tensor(MIX_SEED, dtype=torch.int64, device=device)


def mix_step(h: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """Device fold step: absorb one int32 token into a uint32 hash held in
    int64 (``tok`` any integer dtype; its low 32 bits are absorbed)."""
    h = _mul32(h ^ (tok.to(torch.int64) & _MASK32), _M1)
    h = h ^ (h >> 15)
    h = _mul32(h, _M2)
    return h ^ (h >> 13)
