"""``chip_smoke.py``'s ``shard_quality`` phase (phase 16) at a small size on
the CPU: the sharded confusion matrix and histogram AUROC over
``ThreadWorld`` ranks against one replicated metric (synced, adopted,
snapshotted at world 4 and restored at world 2, bitwise), the bucketed
sharded stream, the watched DLRM and ImageNet panels beside their
unwatched twins, and drift with the health server's quality sections.
Its in-step sync case runs over a spawned gloo world of 2, as the phase's
launcher workers run it on the card; the NCCL world-1 case needs the
card."""

from __future__ import annotations

import os
from pathlib import Path

import torch
import torch.distributed as dist

import chip_smoke
from torcheval_tpu_torch.obs import quality

CPU = "cpu"
REPO = Path(__file__).resolve().parents[1]


def test_phase_shard_quality_small_on_cpu():
    try:
        out = chip_smoke.phase_shard_quality(
            CPU, cm_n=9 * 64 + 17, num_classes=23, cm_batch=64, ctr_n=30 * 512 + 100,
            ctr_batch=512, thresholds=4096, auroc_drain_every=2, timing_batches=3,
            bucket_classes=20, variable=(64, 64, 60, 37, 32, 17, 7, 3), quality_batches=6,
            num_bins=64, host_reps=8, drift_batches=4, mp=False, seed=3,
        )
    finally:
        assert quality.active_watches() == []
    assert out["phase"] == "shard_quality"
    cm, au = out["confusion_matrix"], out["histogram_auroc"]
    assert cm["num_classes"] == 23 and cm["matrix_width"] == 24 and au["thresholds"] == 4096
    for fam in (cm, au):
        assert max(fam["per_rank_bytes"]) <= fam["logical_bytes"] // 4 + 64 * 1024
        assert max(fam["payload_bytes"]["sharded"]) < fam["payload_bytes"]["replicated"]
        assert len(fam["restore_seconds"]) == 2
    assert au["drains_a_rank"] > 0 and cm["drains_a_rank"] == 0
    # the CPU path captures no graph and launches no K1
    assert out["bucket"]["captures"] == 0 and out["imagenet"]["captures"] == {"unwatched": 0,
                                                                             "watched": 0}
    assert out["k1_launches"] == 0
    assert out["drift"]["breach"] and out["drift"]["alerts"]
    assert set(out["host_and_fold"]["host_us_median"]) == {"unwatched", "watched"}


def _gloo_rank(rank, world, out_dir):
    from torcheval_tpu_torch.distributed import MultiHostGroup

    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(out_dir, "store"), world),
                            rank=rank, world_size=world)
    try:
        result = chip_smoke._sync_case(rank, world, torch.device(CPU), MultiHostGroup(), seed=5)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_in_step_sync_case_over_two_gloo_processes(tmp_path):
    chip_smoke._spawn_ranks(_gloo_rank, 2, (str(tmp_path),), 180)
    for r in range(2):
        got = torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
        assert got["rank"] == r and got["world"] == 2
        assert sorted(got["bitwise"]) == ["buf", "carry", "cm", "max", "num_correct", "num_total"]


def test_import_rule_covers_the_new_modules():
    """``test_torch_port_core``'s import rule walks the whole package; the
    sharded-state and data-quality modules are in it, and none imports
    JAX or the JAX package."""
    from tests.test_torch_port_core import _imported_modules, _port_sources

    sources = {p.relative_to(REPO).as_posix() for p in _port_sources()}
    for path in ("torcheval_tpu_torch/metrics/shardspec.py", "torcheval_tpu_torch/metrics/sharded.py",
                 "torcheval_tpu_torch/obs/sketch.py", "torcheval_tpu_torch/obs/quality.py"):
        assert path in sources, path
        roots = {m.split(".")[0] for m in _imported_modules(REPO / path)}
        assert not roots & {"jax", "jaxlib", "flax", "torcheval_tpu"}, (path, roots)
