"""Metric checkpoint/resume helpers.

Counterpart of ``torcheval_tpu/utils/checkpoint.py``: ``save_metric_state``
and ``load_metric_state`` write and read a metric's (or a ``{name:
Metric}`` collection's) ``state_dict`` tree, and restore routes through
``load_state_dict`` so device placement and state validation apply.

The one difference is the file format. The JAX package writes its tree
through Orbax; this package writes the same plain tree (numpy leaves,
Python scalars, the empty-array encoding, the ``__digest__`` key) as one
pickle, ``state.pkl``, inside the atomically renamed checkpoint
directory. So the two packages cannot read each other's checkpoint
directories, but the digest of a state is the same in both (``_digest``
walks the same leaves in the same order), and state crosses between the
packages through ``state_dict`` and numpy as before.

Fault tolerance, as in the JAX package:

- **Atomic publish**: ``save_metric_state`` writes a temporary sibling
  (``<path>.tmp``) and renames it into place; the previous checkpoint is
  set aside (``<path>.old``) until the swap lands, so a crash mid-save
  leaves the previous checkpoint or none, never a torn one.
- **Payload digest**: a sha256 over the canonical byte encoding of every
  state leaf travels inside the checkpoint; ``load_metric_state``
  recomputes it and rejects a corrupt or truncated checkpoint.
- **Schema validation**: restored leaves are checked against the metric's
  registered state shapes and dtypes before anything loads
  (``validate_state_dict``), naming the offending leaf.
- **Single writer**: the ``.tmp``/``.old`` names are fixed so a restarted
  process can recover a crashed predecessor's leftovers; a ``<path>.lock``
  created ``O_EXCL`` fails a second live writer loudly, and a lock older
  than ``_LOCK_STALE_SECONDS`` is presumed a crashed writer's and broken
  with a warning.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import shutil
import struct
import time
import warnings
from typing import Any, Dict, Union

import numpy as np
import torch

from torcheval_tpu_torch.metrics.metric import Metric
from torcheval_tpu_torch.utils.convert import tensor_to_numpy

MetricOrCollection = Union[Metric, Dict[str, Metric]]

# digest sidecar key inside the saved tree (reserved; not a metric name)
_DIGEST_KEY = "__digest__"

# the one file inside a checkpoint directory
_TREE_FILE = "state.pkl"


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor as a read-only host array: read-only, as the JAX package's
    ``np.asarray`` of a device array is, so that it pickles to the same
    bytes (numpy pickles a writeable array's buffer as a bytearray)."""
    arr = tensor_to_numpy(t)
    arr.flags.writeable = False
    return arr


def _to_plain(tree):
    """A ``state_dict`` tree -> the plain tree the JAX package writes:
    tensors as read-only host numpy in their own dtype (the states already
    hold the JAX package's dtypes), Python scalars as they are, and a zero-size
    array (a fresh buffered metric's lazy sentinel) encoded as its shape
    and a one-element prototype of its dtype."""
    if isinstance(tree, dict):
        return {k: _to_plain(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_plain(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        tree = _host(tree)
    if isinstance(tree, np.ndarray) and tree.size == 0:
        return {
            "__empty_shape__": np.asarray(tree.shape, np.int64),
            "__empty_proto__": np.zeros((1,), tree.dtype),
        }
    return tree


def _from_plain(tree):
    """Inverse of :func:`_to_plain`'s empty-array encoding."""
    if isinstance(tree, dict):
        if set(tree) == {"__empty_shape__", "__empty_proto__"}:
            return np.zeros(
                tuple(int(d) for d in tree["__empty_shape__"]),
                tree["__empty_proto__"].dtype,
            )
        return {k: _from_plain(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_from_plain(v) for v in tree]
    return tree


_I64 = struct.Struct("=q")
_F64 = struct.Struct("=d")
_INT64_MIN, _INT64_MAX = -(2**63), 2**63 - 1


def _digest(tree: Any) -> str:
    """sha256 over a canonical byte encoding of the plain state tree, the
    JAX package's digest for the same state.

    Every leaf is canonicalized through ``np.asarray`` (Python ints and
    floats and their numpy-scalar forms encode alike), and the key path,
    dtype and shape are folded in so a corrupted, truncated or transposed
    payload cannot collide with the original.
    """
    h = hashlib.sha256()

    def walk(node: Any, path: str) -> None:
        if isinstance(node, dict):
            for key in sorted(node, key=repr):
                walk(node[key], f"{path}/{key!r}")
        elif isinstance(node, (list, tuple)):
            for i, item in enumerate(node):
                walk(item, f"{path}[{i}]")
        elif type(node) is int and _INT64_MIN <= node <= _INT64_MAX:
            # np.asarray's encoding of a Python int or float, without the
            # array: a snapshot's host mirrors hold many thousands of them
            h.update(path.encode() + b"int64()" + _I64.pack(node))
        elif type(node) is float:
            h.update(path.encode() + b"float64()" + _F64.pack(node))
        else:
            if isinstance(node, torch.Tensor):
                node = _host(node)
            arr = np.asarray(node)
            h.update(path.encode())
            h.update(str(arr.dtype).encode())
            h.update(str(arr.shape).encode())
            h.update(np.ascontiguousarray(arr).tobytes())

    walk(tree, "")
    return h.hexdigest()


def _as_array(value: Any) -> np.ndarray:
    return _host(value) if isinstance(value, torch.Tensor) else np.asarray(value)


def _leaf_desc(value: Any) -> str:
    arr = _as_array(value)
    return f"{arr.dtype}[{', '.join(str(d) for d in arr.shape)}]"


def validate_state_dict(
    metric: Metric, state: Dict[str, Any], *, context: str, prefix: str = ""
) -> None:
    """Check a restored state tree against ``metric``'s registered states
    (``_add_state`` defaults) and raise a clear :class:`RuntimeError`
    naming the offending leaf path.

    Rules per registered default:

    - tensor default with a real shape (``numel > 0``): the restored leaf
      must be an array of the same dtype and shape;
    - tensor default that is a lazy 0-size sentinel (growable buffers fix
      dtype and row shape on the first append): only array-ness;
    - list / dict defaults: the restored leaf must be a list / dict;
    - int/float defaults: the restored leaf must be a scalar (Python or
      0-d numpy number).

    Shared by :func:`load_metric_state` and
    ``elastic.ElasticSession.restore``.
    """
    what = type(metric).__name__
    for name, value in state.items():
        default = metric._state_name_to_default.get(name)
        if default is None:
            continue  # unknown names are strict-mode territory, not ours
        leaf = f"{prefix}{name}"
        if isinstance(default, torch.Tensor):
            if not isinstance(value, (torch.Tensor, np.ndarray)):
                raise RuntimeError(
                    f"{context}: state '{leaf}' holds "
                    f"{type(value).__name__!r} but {what} registered an "
                    f"array state ({_leaf_desc(default)})"
                )
            if default.numel() == 0:
                continue  # lazy sentinel: dtype/shape fixed by first append
            d, v = _as_array(default), _as_array(value)
            info = (getattr(metric, "_sharded_states", None) or {}).get(name)
            if info is not None:
                # a sharded state: the payload may be ANY world's slice of
                # the logical state (a world-size-change restore loads old
                # shards, a merged result is logical) -- dtype, rank and
                # the other dims must match; the shard dim may be any
                # size up to the logical one
                logical = tuple(info.logical_shape)
                if not (
                    v.dtype == d.dtype
                    and v.ndim == len(logical)
                    and tuple(v.shape[1:]) == logical[1:]
                    and 0 < v.shape[0] <= logical[0]
                ):
                    raise RuntimeError(
                        f"{context}: sharded state '{leaf}' holds "
                        f"{_leaf_desc(value)} but {what} registered a "
                        f"state of logical shape {logical} "
                        f"({d.dtype}) — was the checkpoint written by a "
                        "differently-configured metric?"
                    )
                continue
            if v.dtype != d.dtype or v.shape != d.shape:
                raise RuntimeError(
                    f"{context}: state '{leaf}' holds {_leaf_desc(value)} "
                    f"but {what} registered {_leaf_desc(default)} — was "
                    "the checkpoint written by a differently-configured "
                    "metric?"
                )
        elif isinstance(default, list):
            if not isinstance(value, (list, tuple)):
                raise RuntimeError(
                    f"{context}: state '{leaf}' holds "
                    f"{type(value).__name__!r} but {what} registered a "
                    "list state"
                )
        elif isinstance(default, dict):
            if not isinstance(value, dict):
                raise RuntimeError(
                    f"{context}: state '{leaf}' holds "
                    f"{type(value).__name__!r} but {what} registered a "
                    "dict state"
                )
        elif isinstance(default, (int, float)):
            scalar = (
                isinstance(value, (int, float, np.number))
                or (isinstance(value, np.ndarray) and value.ndim == 0)
            )
            if not scalar:
                raise RuntimeError(
                    f"{context}: state '{leaf}' holds "
                    f"{type(value).__name__!r} but {what} registered a "
                    "scalar state"
                )


# A crashed writer's leftover lock is broken after this many seconds; a
# younger foreign lock means a concurrent live writer: a loud error.
_LOCK_STALE_SECONDS = 600.0


def _acquire_save_lock(path: str) -> str:
    """Single-writer guard for one checkpoint path (module docstring)."""
    lock = f"{path}.lock"
    for attempt in (0, 1):
        try:
            fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            os.write(fd, f"pid={os.getpid()} t={time.time()}\n".encode())
            os.close(fd)
            return lock
        except FileExistsError:
            try:
                age = time.time() - os.path.getmtime(lock)
            except OSError:
                continue  # holder just released it: retry the O_EXCL
            if age > _LOCK_STALE_SECONDS and attempt == 0:
                warnings.warn(
                    f"breaking stale checkpoint lock {lock} "
                    f"({age:.0f}s old — presumed crashed writer)",
                    RuntimeWarning,
                )
                # break by atomic rename to a unique name, not unlink: with
                # several contenders, an unlink could remove a rival's
                # fresh lock; a rename moves exactly the stale file
                tomb = f"{lock}.stale-{os.getpid()}-{time.monotonic_ns()}"
                try:
                    os.rename(lock, tomb)
                    os.unlink(tomb)
                except OSError:
                    pass  # a rival broke it first; retry the O_EXCL
                continue
            raise RuntimeError(
                f"another save_metric_state writer holds {lock}: the "
                "atomic-publish protocol uses FIXED (pid-less) "
                f"'{os.path.basename(path)}.tmp'/'.old' siblings so a "
                "restarted process can recover a crashed save, which "
                "makes two CONCURRENT writers to the same path mutually "
                "destructive (silently interleaved renames). Serialize "
                "savers or give each its own path; a lock older than "
                f"{_LOCK_STALE_SECONDS:.0f}s is presumed stale and "
                "broken automatically."
            )
    raise RuntimeError(f"could not acquire checkpoint lock {lock}")


def _write_tree(directory: str, tree: Dict[str, Any]) -> None:
    os.makedirs(directory)
    with open(os.path.join(directory, _TREE_FILE), "wb") as f:
        pickle.dump(tree, f, protocol=pickle.HIGHEST_PROTOCOL)
        f.flush()
        os.fsync(f.fileno())


def save_metric_state(metric: MetricOrCollection, path: str) -> None:
    """Write a metric's (or a ``{name: Metric}`` collection's) state to the
    checkpoint directory ``path``, atomically, with an embedded payload
    digest (see module docstring).

    For a distributed eval loop, snapshot the *synced* state instead:
    ``save_metric_state(get_synced_metric(metric, pg), path)``.

    >>> save_metric_state(metric, "/ckpt/metrics/step_1000")
    >>> save_metric_state({"acc": acc, "auroc": auroc}, "/ckpt/metrics")
    """
    path = os.path.abspath(os.fspath(path))
    if isinstance(metric, Metric):
        tree = {"__single__": _to_plain(metric.state_dict())}
    else:
        if _DIGEST_KEY in metric:
            raise ValueError(
                f"{_DIGEST_KEY!r} is reserved for the checkpoint integrity "
                "digest and cannot be a metric name"
            )
        tree = {name: _to_plain(m.state_dict()) for name, m in metric.items()}
    # digest the logical tree (empty-array encodings decoded), which is
    # exactly what load recomputes over
    tree[_DIGEST_KEY] = np.frombuffer(
        bytes.fromhex(_digest(_from_plain(tree))), dtype=np.uint8
    ).copy()
    lock = _acquire_save_lock(path)
    try:
        tmp = f"{path}.tmp"
        old = f"{path}.old"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        # a previous save may have crashed between its two renames, leaving
        # the last good snapshot only at the aside name: recover it first
        if not os.path.exists(path) and os.path.exists(old):
            os.rename(old, path)
        _write_tree(tmp, tree)
        # the previous checkpoint is renamed aside (never deleted) until
        # the new one is in place, so no crash point destroys the last
        # good snapshot
        if os.path.exists(old):
            shutil.rmtree(old)
        had_old = os.path.exists(path)
        if had_old:
            os.rename(path, old)
        try:
            os.rename(tmp, path)
        except BaseException:
            if had_old:
                os.rename(old, path)  # roll the previous checkpoint back
            raise
        if had_old:
            shutil.rmtree(old, ignore_errors=True)
    finally:
        try:
            os.unlink(lock)
        except OSError:
            pass


def _read_tree(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, _TREE_FILE), "rb") as f:
        return pickle.load(f)


def load_metric_state(
    metric: MetricOrCollection, path: str, strict: bool = True
) -> MetricOrCollection:
    """Restore state saved by :func:`save_metric_state` into ``metric`` in
    place (construct the metric(s) with the same config first). Returns
    ``metric``.

    >>> metric = MulticlassAccuracy()
    >>> load_metric_state(metric, "/ckpt/metrics/step_1000")
    """
    from torcheval_tpu_torch.metrics.toolkit import _restore_state_types

    path = os.path.abspath(os.fspath(path))
    if not os.path.exists(path):
        aside = f"{path}.old"
        if os.path.exists(aside):
            # a save crashed between its two renames: the last good
            # snapshot survives at the aside name
            os.rename(aside, path)
        else:
            # a missing checkpoint is NOT corruption: resume harnesses
            # branch on this distinction (start fresh vs alert)
            raise FileNotFoundError(f"no metric checkpoint at {path}")
    try:
        tree = _from_plain(_read_tree(path))
    except Exception as e:  # a torn pickle raises many types
        raise RuntimeError(
            f"checkpoint at {path} is corrupt or truncated "
            f"(restore failed: {type(e).__name__}: {e})"
        ) from e
    saved_digest = tree.pop(_DIGEST_KEY, None)
    if saved_digest is not None:
        want = bytes(bytearray(int(b) for b in saved_digest)).hex()
        got = _digest(tree)
        if got != want:
            raise RuntimeError(
                f"checkpoint at {path} is corrupt: payload digest mismatch "
                f"(stored {want[:16]}…, recomputed {got[:16]}…); refusing "
                "to restore garbage metric state"
            )
    if isinstance(metric, Metric):
        if "__single__" not in tree:
            raise RuntimeError(
                f"checkpoint at {path} holds a metric collection "
                f"({sorted(tree)}); pass the matching {{name: Metric}} dict."
            )
        validate_state_dict(metric, tree["__single__"], context=f"checkpoint at {path}")
        metric.load_state_dict(_restore_state_types(tree["__single__"]), strict=strict)
        return metric
    if "__single__" in tree:
        raise RuntimeError(
            f"checkpoint at {path} holds a single metric's state; pass a "
            "Metric, not a collection."
        )
    missing = set(metric) - set(tree)
    unexpected = set(tree) - set(metric)
    if strict and (missing or unexpected):
        raise RuntimeError(
            f"checkpoint at {path} does not match the collection: "
            f"missing state for {sorted(missing)}, "
            f"unclaimed saved state for {sorted(unexpected)}."
        )
    for name, m in metric.items():
        if name in tree:
            validate_state_dict(
                m, tree[name], context=f"checkpoint at {path}", prefix=f"{name}."
            )
            m.load_state_dict(_restore_state_types(tree[name]), strict=strict)
    return metric
