"""Multi-process evaluation with metric state synced across processes.

The spawned-worker mode of the reference's distributed example: each
process is one rank of a ``torch.distributed`` job, updates its own
metrics on its own data shard, and every ``SYNC_EVERY`` steps
``sync_and_compute_collection`` merges the whole collection over a
``MultiHostGroup`` in one batched exchange. Run it on one machine, each
worker a CPU process over gloo::

    python -m torcheval_tpu_torch.launcher --nproc 4 --platform cpu \\
        torcheval_tpu_torch/examples/multihost_example.py --device cpu

``launcher.init_from_env()`` joins the job the launcher describes and is a
no-op otherwise, so the script also runs alone, or inside a process group
its caller already made (NCCL on the card). For one process holding every
replica see ``distributed_example.py``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

if __name__ == "__main__" and __package__ in (None, ""):
    # run as a file by the launcher: the checkout root holds the package
    sys.path.append(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch
import torch.distributed as dist

from torcheval_tpu_torch import launcher
from torcheval_tpu_torch.distributed import MultiHostGroup, default_process_group
from torcheval_tpu_torch.metrics import BinaryAUROC, MulticlassAccuracy, Throughput
from torcheval_tpu_torch.metrics.toolkit import sync_and_compute_collection

STEPS, BATCH, CLASSES = 12, 64, 10
SYNC_EVERY = 4  # the reference syncs every 4 batches


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    joined = not dist.is_initialized() and launcher.ENV_COORDINATOR in os.environ
    if joined:
        launcher.init_from_env()
    try:
        return _evaluate(args)
    finally:
        if joined:
            dist.destroy_process_group()


def _evaluate(args) -> dict:
    group = MultiHostGroup() if dist.is_initialized() else default_process_group()
    rank = group.rank
    device = torch.device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", rank % max(1, torch.cuda.device_count()))
    gen = torch.Generator(device).manual_seed(rank)  # this rank's shard

    metrics = {
        "acc": MulticlassAccuracy(device=device),
        "auroc": BinaryAUROC(device=device),
        "throughput": Throughput(device=device),
    }
    synced = {}
    for step in range(1, STEPS + 1):
        t0 = time.perf_counter()
        # stand-in for a model forward on this rank's data shard
        logits = torch.randn((BATCH, CLASSES), generator=gen, device=device)
        targets = torch.randint(0, CLASSES, (BATCH,), generator=gen, device=device)
        scores = torch.softmax(logits, dim=-1)[:, 0]
        is_zero = (targets == 0).to(torch.float32)
        metrics["acc"].update(logits, targets)
        metrics["auroc"].update(scores, is_zero)
        metrics["throughput"].update(BATCH, time.perf_counter() - t0)

        if step % SYNC_EVERY == 0:
            # ONE batched exchange for the whole collection
            synced = {k: float(v) for k, v in sync_and_compute_collection(metrics, group).items()}
            if rank == 0:
                print(f"step {step}: acc={synced['acc']:.4f} auroc={synced['auroc']:.4f} "
                      f"throughput={synced['throughput']:.0f}/s "
                      f"(pooled over {group.world_size} processes)", flush=True)

    for m in metrics.values():
        m.reset()
    if rank == 0:
        print("done", flush=True)
    return {"rank": rank, "world_size": group.world_size, "synced": synced}


if __name__ == "__main__":
    main()
