"""Multi-process launcher for single-machine ``torch.distributed`` jobs.

Counterpart of ``torcheval_tpu/launcher.py``: N OS processes that join one
``torch.distributed`` gloo group over a localhost (or given) TCP address,
each one rank of the job. Metric sync payloads are host numpy (as in
``distributed.MultiHostGroup``), so gloo carries them whether the metrics
live on a card or on the CPU.

Two surfaces:

- CLI::

    python -m torcheval_tpu_torch.launcher --nproc 4 my_eval.py --my-flag

  Each worker re-runs ``my_eval.py`` with ``TE_TPU_{COORDINATOR,NPROC,RANK}``
  exported (the JAX package's names); the script opts in by calling
  :func:`init_from_env`.

- Python API: :func:`launch` with a script path and argv.

Workers see the card by default (``platform=None``): N torch processes
can share one CUDA device, each with its own context. ``platform="cpu"``
hides it (``CUDA_VISIBLE_DEVICES=""``), which is what CPU tests pass.
This default differs from the JAX launcher's ``platform="cpu"`` on
purpose: N instances of a TPU plugin cannot claim the same chip, so the
JAX launcher keeps its workers off the accelerator unless told otherwise.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from typing import List, Optional, Sequence

ENV_COORDINATOR = "TE_TPU_COORDINATOR"
ENV_NPROC = "TE_TPU_NPROC"
ENV_RANK = "TE_TPU_RANK"

_PLATFORMS = (None, "cpu")


def init_from_env(timeout: float = 300.0) -> int:
    """Join the gloo group described by the launcher's env vars.

    Returns this worker's rank. A no-op (returning 0) when the env vars
    are absent, so the same script runs unchanged single-process.
    ``timeout`` bounds every collective of the group: gloo cannot abort
    a collective in flight, so a dead peer costs at most this wait
    before the blocked worker thread of a ``ResilientGroup`` returns.
    """
    import torch.distributed as dist

    coord = os.environ.get(ENV_COORDINATOR)
    if coord is None:
        return 0
    nproc = int(os.environ[ENV_NPROC])
    rank = int(os.environ[ENV_RANK])
    dist.init_process_group(
        "gloo",
        init_method=f"tcp://{coord}",
        world_size=nproc,
        rank=rank,
        timeout=timedelta(seconds=timeout),
    )
    return rank


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch(
    script: str,
    script_args: Sequence[str] = (),
    *,
    nproc: int = 2,
    coordinator: Optional[str] = None,
    platform: Optional[str] = None,
    timeout: float = 600.0,
    env: Optional[dict] = None,
) -> List[str]:
    """Run ``script`` on ``nproc`` cooperating processes; returns each
    worker's captured stdout+stderr (rank order). Raises ``RuntimeError``
    with the failing rank's tail if any worker exits non-zero, or with the
    hung ranks' tail after ``timeout`` seconds (all workers are killed).

    ``platform``: ``None`` (workers inherit the parent's view of the
    cards) or ``"cpu"`` (the cards are hidden).
    """
    if platform not in _PLATFORMS:
        raise ValueError(f"platform must be one of {_PLATFORMS}, got {platform!r}")
    coordinator = coordinator or f"127.0.0.1:{free_port()}"
    base_env = dict(os.environ if env is None else env)
    if platform == "cpu":
        base_env["CUDA_VISIBLE_DEVICES"] = ""
    base_env[ENV_COORDINATOR] = coordinator
    base_env[ENV_NPROC] = str(nproc)

    # worker output goes to temp FILES, not pipes: a rank that fills a pipe
    # buffer mid-collective would block, deadlocking the whole job while the
    # parent drains some other rank
    procs, logs = [], []
    for rank in range(nproc):
        worker_env = dict(base_env)
        worker_env[ENV_RANK] = str(rank)
        log = tempfile.TemporaryFile("w+", errors="replace")
        logs.append(log)
        procs.append(
            subprocess.Popen(
                [sys.executable, script, *script_args],
                env=worker_env,
                stdout=log,
                stderr=subprocess.STDOUT,
                text=True,
            )
        )

    def read_log(rank: int) -> str:
        logs[rank].seek(0)
        return logs[rank].read()

    def kill_all():
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:  # reap: no zombies, logs quiesce before reading
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass

    # fail-fast poll: one crashed rank leaves its peers blocked in
    # collectives; report the crash, not the peers' hang
    deadline = time.monotonic() + timeout  # shared: total, not per-rank
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = next((r for r, c in enumerate(codes) if c not in (None, 0)), None)
            if bad is not None:
                kill_all()
                raise RuntimeError(
                    f"worker rank {bad} exited with {codes[bad]}:\n"
                    f"{read_log(bad)[-2000:]}"
                )
            if all(c == 0 for c in codes):
                return [read_log(r) for r in range(nproc)]
            if time.monotonic() > deadline:
                hung = [r for r, c in enumerate(codes) if c is None]
                kill_all()
                raise RuntimeError(
                    f"worker rank(s) {hung} timed out after {timeout:.0f}s:\n"
                    f"{read_log(hung[0])[-2000:]}"
                )
            time.sleep(0.05)
    finally:
        kill_all()
        for log in logs:
            log.close()


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m torcheval_tpu_torch.launcher",
        description="Launch a script on N cooperating torch.distributed "
        "processes (workers call torcheval_tpu_torch.launcher.init_from_env()).",
    )
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--coordinator", default=None,
                    help="host:port (default: localhost, free port)")
    ap.add_argument("--platform", default="inherit", choices=("inherit", "cpu"),
                    help="'inherit' (default) lets workers see the cards; "
                    "'cpu' hides them")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("script")
    ap.add_argument("script_args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)

    outputs = launch(
        args.script,
        args.script_args,
        nproc=args.nproc,
        coordinator=args.coordinator,
        platform=None if args.platform == "inherit" else args.platform,
        timeout=args.timeout,
    )
    for rank, out in enumerate(outputs):
        for line in out.rstrip().splitlines():
            print(f"[rank {rank}] {line}")


if __name__ == "__main__":
    main()
