"""``chip_smoke.py``'s ``obs`` phase (phase 15) at a small size on the CPU,
and the slice's observability as a whole against the JAX package: the
DLRM panel with the recorder off, on, and armed with the JSONL writer,
the watchdog and the health server, a ragged bucketed panel, a four-rank
flat and hierarchical sync, a slow peer, a snapshot and restore, the
server's endpoints and the files written at scope exit."""

from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
import torcheval_tpu.metrics as JM
from torcheval_tpu import config as jconfig
from torcheval_tpu import obs as jobs
from torcheval_tpu.metrics import toolkit as jtoolkit
import torcheval_tpu_torch.metrics as TM
from torcheval_tpu_torch import config as tconfig
from torcheval_tpu_torch import obs as tobs
from torcheval_tpu_torch.metrics import toolkit as ttoolkit

CPU = "cpu"
REPO = Path(__file__).resolve().parents[1]


def test_phase_obs_small_on_cpu():
    out = chip_smoke.phase_obs(
        CPU, n=12 * 512, batch=512, batches=12, num_bins=64, rank_batches=2,
        num_classes=20, variable=(64, 64, 60, 37, 32, 17, 7, 3), host_reps=8,
    )
    assert out["phase"] == "obs"
    assert set(out["timing"]) == {"off", "on", "armed", "off_again"}
    assert out["sync"]["node_collectives"] == [4, 4, 4, 4]
    assert out["sync"]["leader_collectives"] == [2, 0, 2, 0]
    assert out["slow_peer"]["stall_rank"] == out["slow_peer"]["diff_stalled_rank"] == 2
    assert out["server"]["healthz_status"] == 200
    assert out["files"]["jsonl_lines"] > 0
    # the CPU path uses K1's plain version: no launch is counted
    assert out["k1_launches"]["armed"] == 0
    assert out["imagenet"]["captures"] == 0 <= out["imagenet"]["bound"]


def test_dlrm_panel_event_stream_matches_jax():
    """The phase's DLRM panel at a small size through both packages with
    the recorder on: the same update events (one a panel call, ``fused``
    the metrics it covered), step cursors and latency-digest keys, and the
    panel values equal within float32 accumulation."""
    rng = np.random.default_rng(5)
    batches = [(rng.random(256).astype(np.float32), (rng.random(256) < 0.1).astype(np.float32))
                for _ in range(4)]

    def run(M, toolkit, config, obs, arr, kw):
        panel = {
            "ne": M.BinaryNormalizedEntropy(**kw),
            "calibration": M.WeightedCalibration(**kw),
            "auroc": M.StreamingBinaryAUROC(num_bins=64, **kw),
            "auprc": M.StreamingBinaryAUPRC(num_bins=64, **kw),
        }
        ctr = M.ClickThroughRate(**kw)
        obs.recorder().reset()
        obs.hist.reset()
        with config.observability():
            for step, (s, y) in enumerate(batches):
                obs.recorder().set_step(step)
                toolkit.update_collection(panel, arr(s), arr(y))
                toolkit.update_collection({"ctr": ctr}, arr(y))
            # compile events left out: XLA program demands in one package,
            # CUDA-graph captures (none on the CPU) in the other
            events = [(e.kind, e.metric, e.fused, e.step)
                      for e in obs.recorder().log.tail() if e.kind != "compile"]
            digests = sorted(obs.latency_snapshot())
        values = {k: float(np.asarray(m.compute()).reshape(-1)[0]) for k, m in panel.items()}
        values["ctr"] = float(np.asarray(ctr.compute()).reshape(-1)[0])
        return events, digests, values

    jev, jdig, jval = run(JM, jtoolkit, jconfig, jobs, jnp.asarray, {})
    tev, tdig, tval = run(TM, ttoolkit, tconfig, tobs, torch.from_numpy, {"device": CPU})
    assert tev == jev
    assert tdig == jdig
    for k in jval:
        np.testing.assert_allclose(tval[k], jval[k], rtol=1e-5)


def test_import_rule_covers_every_obs_module():
    """``test_torch_port_core``'s import rule walks the whole package; the
    observability modules are in it, none imports JAX or the JAX package."""
    from tests.test_torch_port_core import _imported_modules, _port_sources

    sources = {p.relative_to(REPO).as_posix() for p in _port_sources()}
    for name in ("events", "trace", "hist", "recorder", "flight", "counters", "export",
                 "monitor", "watchdog", "memory", "server", "__init__"):
        path = f"torcheval_tpu_torch/obs/{name}.py"
        assert path in sources, path
        roots = {m.split(".")[0] for m in _imported_modules(REPO / path)}
        assert not roots & {"jax", "jaxlib", "flax", "torcheval_tpu"}, (path, roots)
    assert "torcheval_tpu_torch/utils/compile_counter.py" in sources
