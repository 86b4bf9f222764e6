"""torcheval_tpu_torch's ``launcher`` against the JAX package's: the same
``TE_TPU_{COORDINATOR,NPROC,RANK}`` variables and CLI, rank-prefixed
output, a failing rank reported with its exit code, and one spawned
2-worker gloo job (``platform="cpu"``) in which each worker updates CPU
metrics under ``ElasticSession(async_writer=True)`` on ``MultiHostGroup``
and syncs through a ``ResilientGroup``; both ranks must agree, the sync
must equal the one-process merge bitwise (integer-valued data), and a
relaunch at world 1 must restore the bundle to the same state.

The port's default ``platform=None`` lets workers see the card; the tests
pass ``platform="cpu"``, which hides it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from torcheval_tpu import launcher as jlauncher
import torcheval_tpu_torch.metrics as TM
from torcheval_tpu_torch import launcher
from torcheval_tpu_torch.launcher import ENV_COORDINATOR, free_port, init_from_env, launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent('''
    import json, os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torcheval_tpu_torch.distributed import MultiHostGroup
    from torcheval_tpu_torch.elastic import ElasticSession
    from torcheval_tpu_torch.launcher import init_from_env
    from torcheval_tpu_torch.metrics import MulticlassAccuracy, Sum
    from torcheval_tpu_torch.metrics.toolkit import get_synced_metric_collection
    from torcheval_tpu_torch.resilience import ResilientGroup

    rank = init_from_env(timeout=60.0)
    group = MultiHostGroup()
    metrics = {"acc": MulticlassAccuracy(device="cpu"), "sum": Sum(device="cpu")}
    session = ElasticSession(metrics, sys.argv[1], process_group=group, interval=2,
                             async_writer=True)
    restored = session.restore()
    if restored is None:
        rng = np.random.default_rng(rank)
        for step in range(4):
            x = rng.integers(0, 8, (16, 4)).astype(np.float32)
            metrics["acc"].update(x, rng.integers(0, 4, 16))
            metrics["sum"].update(x[:, 0])
            session.step_done(step)
    session.close()
    if group.world_size > 1:
        metrics = get_synced_metric_collection(
            metrics, ResilientGroup(group, timeout=30.0, policy="quorum"))
    print("RESULT " + json.dumps({
        "rank": rank, "world": group.world_size,
        "cuda_visible": torch.cuda.is_available(),
        "dedicated": session._comm is not group,
        "restored": None if restored is None else list(restored.assigned_ranks),
        "ranks": list(getattr(metrics["acc"], "sync_provenance", (None,))[0] or []),
        "states": {k: {n: (v.tolist() if hasattr(v, "tolist") else v)
                       for n, v in m.state_dict().items()} for k, m in metrics.items()},
    }))
    dist.destroy_process_group()
''')


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _results(outputs):
    return [json.loads(line.split("RESULT ", 1)[1]) for out in outputs
            for line in out.splitlines() if line.startswith("RESULT ")]


def test_gloo_workers_snapshot_sync_and_relaunch_at_world_one(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    bundle = tmp_path / "bundle"
    first = _results(launch(str(script), [str(bundle)], nproc=2, platform="cpu", timeout=25.0,
                            env=_env()))
    assert [r["rank"] for r in first] == [0, 1]
    assert all(r["world"] == 2 and r["dedicated"] and not r["cuda_visible"] for r in first)
    assert first[0]["states"] == first[1]["states"] and first[0]["ranks"] == [0, 1]
    # the one-process merge of the same per-rank streams
    oracle = {"acc": TM.MulticlassAccuracy(device="cpu"), "sum": TM.Sum(device="cpu")}
    for rank in range(2):
        rng = np.random.default_rng(rank)
        for _ in range(4):
            x = rng.integers(0, 8, (16, 4)).astype(np.float32)
            oracle["acc"].update(x, rng.integers(0, 4, 16))
            oracle["sum"].update(x[:, 0])
    for k, m in oracle.items():
        assert first[0]["states"][k] == {n: v.tolist() for n, v in m.state_dict().items()}
    again = _results(launch(str(script), [str(bundle)], nproc=1, platform="cpu", timeout=25.0,
                            env=_env()))
    assert again[0]["restored"] == [0, 1]
    assert again[0]["states"] == first[0]["states"]


def test_launch_cli_prefixes_ranks(tmp_path):
    script = tmp_path / "echo.py"
    script.write_text("import os\nprint('RESULT', os.environ['TE_TPU_RANK'], "
                      "os.environ['TE_TPU_NPROC'], repr(os.environ['CUDA_VISIBLE_DEVICES']))\n")
    proc = subprocess.run(
        [sys.executable, "-m", "torcheval_tpu_torch.launcher", "--nproc", "2",
         "--platform", "cpu", str(script)],
        capture_output=True, text=True, timeout=60, env=_env(), cwd=REPO,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "[rank 0] RESULT 0 2 ''" in proc.stdout
    assert "[rank 1] RESULT 1 2 ''" in proc.stdout


def test_worker_failure_is_reported(tmp_path):
    bad = tmp_path / "bad_worker.py"
    bad.write_text("import os, sys\nsys.exit(7 if os.environ['TE_TPU_RANK'] == '1' else 0)\n")
    with pytest.raises(RuntimeError, match=r"rank 1 exited with 7"):
        launch(str(bad), nproc=2, platform="cpu", timeout=30.0, env=_env())


def test_hung_worker_times_out_and_is_killed(tmp_path):
    slow = tmp_path / "slow_worker.py"
    slow.write_text("import time\ntime.sleep(0.4)\n")
    with pytest.raises(RuntimeError, match=r"timed out"):
        launch(str(slow), nproc=1, platform="cpu", timeout=0.1, env=_env())


def test_default_platform_lets_workers_see_the_card(tmp_path):
    script = tmp_path / "env.py"
    script.write_text("import os\nprint('RESULT', repr(os.environ.get('CUDA_VISIBLE_DEVICES')))\n")
    env = _env()
    env.pop("CUDA_VISIBLE_DEVICES", None)
    out = launch(str(script), nproc=1, timeout=30.0, env=env)
    assert "RESULT None" in out[0]
    with pytest.raises(ValueError, match="platform"):
        launch(str(script), nproc=1, platform="tpu", env=env)


def test_init_from_env_noop_without_env():
    assert ENV_COORDINATOR not in os.environ
    assert init_from_env() == 0


def test_env_names_and_free_port_match_jax():
    assert (launcher.ENV_COORDINATOR, launcher.ENV_NPROC, launcher.ENV_RANK) == (
        jlauncher.ENV_COORDINATOR, jlauncher.ENV_NPROC, jlauncher.ENV_RANK)
    port = free_port()
    assert 0 < port < 65536
    assert torch.distributed.is_available()
