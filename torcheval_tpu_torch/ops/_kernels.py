"""Build and load the hand-written CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` into its own plain-C
shared library, loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds). Builds happen on first use, into
``build/torcheval_tpu_torch/`` beside the package, under a name keyed by a
hash of the source and the flags: a changed source rebuilds, an unchanged
one loads. ``build_all()`` starts one ``nvcc`` per source, all at once.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no ``nvcc``.

``LAUNCHES`` counts kernel launches by name. A wrapper adds one
(``count_launch``) where it launches its kernel and nowhere else, so a run
can show that its main path went through the kernels. The count is taken
under a lock: ranks emulated as threads of one process launch from
several threads, and a bare ``+= 1`` on a dict entry can lose increments.

``load`` builds and loads under a lock of its own, for the same reason:
two rank threads reaching a kernel on a cold build directory must not both
start ``nvcc``. Every build writes its library and its log under names of
its own (``tempfile``) and renames them into place when it is done.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torcheval_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


# Fields of csrc/fused_auc_hist.cu's K1Launch, in order, as `struct` codes
# (P pointer, q long long, i int, f float). A launch packs them with
# K1_LAUNCH (native alignment, padded to the struct's 8-byte multiple) and
# passes the bytes by pointer: one pack and one pointer cost the host less
# than as many ctypes arguments or a ctypes.Structure.
K1_LAUNCH_FIELDS = (
    ("scores", "P"), ("labels", "P"), ("weights", "P"), ("task_lo", "P"),
    ("task_span", "P"), ("out", "P"), ("label_row_stride", "q"),
    ("weight_row_stride", "q"), ("n", "q"), ("num_tasks", "i"),
    ("num_bins", "i"), ("per_task_bounds", "i"), ("lo", "f"),
    ("inv_span", "f"), ("cluster", "i"), ("clusters_per_task", "i"),
    ("smem_bytes", "i"), ("split", "i"),
)


def _padded(fmt: str) -> struct.Struct:
    return struct.Struct(fmt + f"{-struct.calcsize(fmt) % 8}x")


K1_LAUNCH = _padded("@" + "".join(code for _, code in K1_LAUNCH_FIELDS))


# source stem -> ctypes signature of every exported function
_SIGNATURES = {
    "fused_auc_hist": {
        "tev_fused_auc_hist": (
            ctypes.c_int, [ctypes.c_char_p, ctypes.c_void_p]
        ),
        "tev_fused_auc_hist_init": (ctypes.c_int, [ctypes.c_int]),
        "tev_fused_auc_hist_max_active_clusters": (
            ctypes.c_int, [ctypes.c_int, ctypes.c_int]
        ),
        "tev_fused_auc_hist_global_blocks_per_sm": (ctypes.c_int, []),
        "tev_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
    },
}

LAUNCHES: Dict[str, int] = {"fused_auc_hist": 0}  # tev: guarded-by=_LAUNCHES_LOCK
_LAUNCHES_LOCK = threading.Lock()

_LOADED: Dict[str, ctypes.CDLL] = {}  # tev: guarded-by=_LOAD_LOCK
_LOAD_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    with _LAUNCHES_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def count_launch(name: str) -> None:
    """Add one launch of kernel ``name`` to ``LAUNCHES``."""
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1


def _nvcc() -> str:
    for candidate in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError(
        "nvcc not found (looked on PATH and under CUDA_HOME, default "
        "/usr/local/cuda): the CUDA kernels build on first use and need "
        "the CUDA toolkit"
    )


def _library_path(name: str) -> Path:
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return _BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Start ``nvcc`` for one source; returns (process, log file, temporary
    library path, temporary log path, final path), or None when the library
    is already built. The temporary names are unique to this build, so two
    builds (threads or processes) never share a file."""
    lib = _library_path(name)
    if lib.exists():
        return None
    nvcc = _nvcc()
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=lib.stem + ".", suffix=".so.tmp", dir=_BUILD_DIR)
    os.close(fd)
    fd, tmp_log = tempfile.mkstemp(prefix=lib.stem + ".", suffix=".log.tmp", dir=_BUILD_DIR)
    log = os.fdopen(fd, "w")
    proc = subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-o", tmp, str(_CSRC / f"{name}.cu")],
        stdout=log, stderr=subprocess.STDOUT,
    )
    return proc, log, Path(tmp), Path(tmp_log), lib


def _finish_build(name: str, started) -> None:
    proc, log, tmp, tmp_log, lib = started
    rc = proc.wait()
    log.close()
    # atomic renames: a concurrent reader sees a whole file or none
    os.replace(tmp_log, lib.with_suffix(".log"))
    if rc != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({rc}) building {name}.cu:\n"
            + lib.with_suffix(".log").read_text()
        )
    os.replace(tmp, lib)


def build_all() -> List[str]:
    """Build every kernel source not yet built, one ``nvcc`` per source,
    all started together; returns the names built."""
    started = {}
    for src in sorted(_CSRC.glob("*.cu")):
        job = _start_build(src.stem)
        if job is not None:
            started[src.stem] = job
    for name, job in started.items():
        _finish_build(name, job)
    return sorted(started)


def build_log(name: str) -> str:
    """The compiler output (``-Xptxas -v``: registers, shared memory,
    spills) of the last build of ``name``, or '' when it was never built
    here."""
    log = _library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed.
    One thread builds and loads; the others wait for it and share the
    library."""
    lib = _LOADED.get(name)  # tev: disable=guarded-field -- lock-free probe on the launch path; a miss falls through to the locked check below, which one thread wins
    if lib is not None:
        return lib
    with _LOAD_LOCK:
        lib = _LOADED.get(name)
        if lib is not None:
            return lib
        job = _start_build(name)
        if job is not None:
            _finish_build(name, job)  # tev: disable=blocking-under-lock -- waiting for the one nvcc is the point: the lock keeps a second thread from starting its own build, and no code under it takes another lock
        lib = ctypes.CDLL(str(_library_path(name)))
        for fn_name, (restype, argtypes) in _SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.restype = restype
            fn.argtypes = argtypes
        _LOADED[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error code."""
    if code != 0:
        msg = lib.tev_cuda_error_string(code)
        raise RuntimeError(
            f"{what} failed: CUDA error {code} "
            f"({msg.decode() if msg else 'unknown'})"
        )
