"""Deterministic key hashing for the keyed metric table (a copy of
``torcheval_tpu/table/_hash.py``: every cross-rank and cross-package
contract rests on these values).

The table's cross-run contracts all reduce to one property: the SAME user
key must map to the SAME 64-bit hash in every process, every python run,
and every world size — ownership (``hash % world``), the sorted slot
order, and the elastic re-hash on a world-size change are all derived
from it. Python's builtin ``hash`` is salted per process for strings, so
this module fixes the function instead:

- integer keys hash through **splitmix64** (the statistical-quality
  finalizer of Steele et al.'s SplittableRandom) — branch-free, numpy-
  vectorizable, and identical everywhere;
- string/bytes keys hash through ``blake2b(digest_size=8)`` — stable
  across runs and platforms (unlike ``hash()``).

Device representation: the JAX package holds a 64-bit hash as TWO uint32
**planes** (``hi = hash >> 32``, ``lo = hash & 0xffffffff``) because x64
is off there; the table states keep those planes under the same names.
On the device the port compares one int64 key a hash instead,
``hash ^ 2**63`` read as signed (:func:`order_keys`): flipping the sign
bit makes the signed order equal the unsigned 64-bit order, the sort
order of the host mirror.

``SENTINEL`` (2**64 - 1) marks empty table slots and dropped outbox
entries; a real key hashing to it is remapped to ``SENTINEL - 1`` (a
deterministic 2^-64 event, applied identically everywhere).
"""

from __future__ import annotations

from typing import Any, Sequence, Tuple

import numpy as np

__all__ = ["SENTINEL", "hash_keys", "order_keys", "owner_of", "split_planes"]

# all-ones is the empty-slot / dropped-entry marker; never a real key hash
SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)

_C1 = np.uint64(0x9E3779B97F4A7C15)
_C2 = np.uint64(0xBF58476D1CE4E5B9)
_C3 = np.uint64(0x94D049BB133111EB)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = x + _C1
    x = (x ^ (x >> np.uint64(30))) * _C2
    x = (x ^ (x >> np.uint64(27))) * _C3
    return x ^ (x >> np.uint64(31))


def _hash_str(key: Any) -> int:
    import hashlib

    data = key if isinstance(key, bytes) else str(key).encode("utf-8")
    return int.from_bytes(
        hashlib.blake2b(data, digest_size=8).digest(), "little"
    )


def _hash_one(key: Any) -> int:
    """Type-dispatched element hash for object-dtype inputs: an int key
    must hash the same whether it arrived in an int64 array or an
    object array (numpy promotes to object when any element exceeds
    int64) — so ints always go through splitmix64 (mod 2^64), never
    through their string repr."""
    if isinstance(key, (int, np.integer)) and not isinstance(key, bool):
        return int(
            _splitmix64(
                np.asarray([int(key) & 0xFFFFFFFFFFFFFFFF], np.uint64)
            )[0]
        )
    if isinstance(key, (str, bytes)):
        return _hash_str(key)
    raise TypeError(
        f"table keys must be integers or strings, got {type(key).__name__}"
    )


def hash_keys(keys: Any) -> np.ndarray:
    """``keys`` (int array/sequence, or a sequence of str/bytes) to a
    ``np.uint64`` hash vector. Deterministic across processes, runs, and
    world sizes — the foundation of the table's ownership and elastic
    re-hash contracts."""
    arr = np.asarray(keys)
    if arr.size == 0:
        # an empty key batch carries no dtype signal (np.asarray([]) is
        # float64) — and has nothing to hash either way
        return np.zeros((0,), np.uint64)
    if arr.dtype.kind in ("i", "u"):
        hashed = _splitmix64(arr.astype(np.uint64).reshape(-1))
    elif arr.dtype.kind in ("U", "S"):
        flat: Sequence[Any] = arr.reshape(-1).tolist()
        hashed = np.fromiter(
            (_hash_str(k) for k in flat), dtype=np.uint64, count=len(flat)
        )
    elif arr.dtype.kind == "O":
        flat = arr.reshape(-1).tolist()
        hashed = np.fromiter(
            (_hash_one(k) for k in flat), dtype=np.uint64, count=len(flat)
        )
    else:
        raise TypeError(
            f"table keys must be integers or strings, got dtype {arr.dtype}"
        )
    # reserve the empty-slot sentinel (deterministic 2^-64 remap)
    return np.where(hashed == SENTINEL, SENTINEL - np.uint64(1), hashed)


def owner_of(hashed: np.ndarray, world: int) -> np.ndarray:
    """Owning rank per key hash: ``hash % world`` (uint64 host math — the
    device twin in ``table.py`` reduces the same value from the planes)."""
    return (hashed % np.uint64(world)).astype(np.int64)


def split_planes(hashed: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """One uint64 hash vector -> ``(hi, lo)`` uint32 planes (the device
    representation; lexicographic ``(hi, lo)`` order == uint64 order)."""
    hi = (hashed >> np.uint64(32)).astype(np.uint32)
    lo = (hashed & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return hi, lo


_SIGN = np.uint64(1 << 63)


def order_keys(hashed: np.ndarray) -> np.ndarray:
    """One uint64 hash vector -> int64 keys whose SIGNED order is the
    unsigned order of the hashes (the sign bit flipped). A plain signed
    view would sort hashes at or above 2^63 first."""
    return (np.asarray(hashed, np.uint64) ^ _SIGN).view(np.int64)
