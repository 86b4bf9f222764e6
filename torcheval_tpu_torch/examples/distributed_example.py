"""Data-parallel training with metrics synced across processes.

The torch counterpart of the reference's DDP example: ``--world``
processes, one rank each, train a small classifier under
``DistributedDataParallel`` on their own shards of a synthetic dataset.
Each rank updates its own metrics -- ``MulticlassAccuracy``, exact
``MulticlassAUROC`` over a growable buffer, and ``Throughput`` -- and every
``--sync-every`` steps ``sync_and_compute_collection`` merges them over a
``MultiHostGroup``, the same merged values on every rank. Run:

    python -m torcheval_tpu_torch.examples.distributed_example --world 2 --device cpu

The processes join one gloo process group through a ``FileStore`` in a
temporary directory. ``--device cuda`` keeps each rank's model and metric
state on ``cuda:<rank % device count>``; the sync's bytes still travel
through gloo on the host.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
import torch.nn.functional as F
from torch.nn.parallel import DistributedDataParallel

from torcheval_tpu_torch.distributed import MultiHostGroup
from torcheval_tpu_torch.metrics import MulticlassAccuracy, MulticlassAUROC, Throughput
from torcheval_tpu_torch.metrics.toolkit import sync_and_compute_collection, update_collection

FEATURES, CLASSES, BATCH = 16, 4, 32


def _shard(gen, device):
    """A synthetic batch: class c's features centred on a one-hot at c."""
    y = torch.randint(0, CLASSES, (BATCH,), generator=gen)
    x = torch.randn(BATCH, FEATURES, generator=gen)
    x[torch.arange(BATCH), y] += 2.0
    return x.to(device), y.to(device)


def _worker(rank, world, device, store_path, steps, sync_every, out_path):
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, world), rank=rank, world_size=world
    )
    try:
        if device == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        else:
            dev = torch.device(device)
        torch.manual_seed(0)  # the same initial weights on every rank
        model = DistributedDataParallel(torch.nn.Linear(FEATURES, CLASSES).to(dev))
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        gen = torch.Generator().manual_seed(1000 + rank)  # this rank's shard
        group = MultiHostGroup()
        metrics = {
            "accuracy": MulticlassAccuracy(device=dev),
            "auroc": MulticlassAUROC(num_classes=CLASSES, device=dev),
            "throughput": Throughput(device=dev),
        }
        values = {}
        for step in range(1, steps + 1):
            t0 = time.perf_counter()
            x, y = _shard(gen, dev)
            logits = model(x)
            loss = F.cross_entropy(logits, y)
            opt.zero_grad()
            loss.backward()
            opt.step()
            update_collection(
                {k: metrics[k] for k in ("accuracy", "auroc")}, logits.detach(), y
            )
            metrics["throughput"].update(BATCH, time.perf_counter() - t0)
            if step % sync_every == 0:
                values = {
                    k: float(v)
                    for k, v in sync_and_compute_collection(metrics, group).items()
                }
                if rank == 0:
                    print(f"step {step}: " + ", ".join(f"{k} {v:.4f}" for k, v in values.items()))
        torch.save(values, f"{out_path}.{rank}")
    finally:
        dist.destroy_process_group()


def main(world: int = 2, device: str = "cuda", steps: int = 16, sync_every: int = 4):
    """Train on ``world`` processes; returns every rank's last synced
    values, ``[{metric: value}, ...]`` in rank order."""
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "values")
        mp.spawn(
            _worker,
            args=(world, device, os.path.join(tmp, "store"), steps, sync_every, out_path),
            nprocs=world,
            join=True,
        )
        return [torch.load(f"{out_path}.{r}") for r in range(world)]


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--world", type=int, default=2)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--steps", type=int, default=16)
    parser.add_argument("--sync-every", type=int, default=4)
    args = parser.parse_args()
    main(args.world, args.device, args.steps, args.sync_every)
