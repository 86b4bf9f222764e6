"""The quantized wire ladder (``torcheval_tpu_torch.wire``, the lossy rungs
of ``metrics.synclib`` and the ``config`` knobs) against the JAX package.

The numpy codec, the torch twins and the JAX package's traced twins give
the same bits on random, constant, all-zero, NaN/+-Inf, subnormal and
ragged-tail blocks; the error stays within ``int8_error_bound``; a packed
synclib buffer of either package decodes in the other to identical arrays
at every rung (and the packed bytes and metadata are equal); the ladder
steps int8 -> bf16 -> exact on breaches with one ``WireTierEvent`` a step;
a synced collection names the rung each metric rode; and the config knobs
and their environment variables behave as the JAX package's.

JAX compiles its twins for the CPU, where XLA flushes subnormals to zero:
on the subnormal blocks the JAX twin is held to the torch twin of the
flushed input, and the torch twin to the numpy codec of the raw input.
"""

from __future__ import annotations

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torcheval_tpu.config as JC
import torcheval_tpu.metrics as JM
import torcheval_tpu.wire as JW
import torcheval_tpu_torch.config as PC
import torcheval_tpu_torch.metrics as PM
import torcheval_tpu_torch.wire as PW
from torcheval_tpu.metrics import synclib as JS
from torcheval_tpu_torch import obs as pobs
from torcheval_tpu_torch.distributed import LocalReplicaGroup
from torcheval_tpu_torch.metrics import synclib as PS
from torcheval_tpu_torch.metrics import toolkit as PT

CPU = "cpu"
_RNG = np.random.default_rng(14)


def _blocks():
    r = _RNG
    nonfinite = np.array([1.0, np.nan, np.inf, -np.inf, 2.5, -7.0] * 11, np.float32)
    return {
        "random": r.standard_normal(1000).astype(np.float32),
        "constant": np.full(70, 3.3, np.float32),
        "zeros": np.zeros(64, np.float32),
        "nonfinite": nonfinite,
        "subnormal": (r.standard_normal(100) * 1e-40).astype(np.float32),
        "ragged": r.uniform(-5, 5, 33).astype(np.float32),
        "huge": (r.standard_normal(50) * 1e30).astype(np.float32),
    }


def _u32(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _ftz(a):
    """XLA's CPU flush of subnormal inputs to signed zero."""
    tiny = np.finfo(np.float32).tiny
    return np.where(np.abs(a) < tiny, np.copysign(np.float32(0), a), a).astype(np.float32)


def test_all_lists_match():
    assert PW.__all__ == JW.__all__
    assert PW.RUNGS == JW.RUNGS
    for rung in ("exact", "bf16", "int8", "off"):
        assert PW.rung_index(rung) == JW.rung_index(rung)
        assert PW.normalize_rung(rung) == JW.normalize_rung(rung)
    with pytest.raises(ValueError, match="unknown wire rung"):
        PW.rung_index("fp4")


@pytest.mark.parametrize("block", [32, 7, 2])
@pytest.mark.parametrize("kind", list(_blocks()))
def test_numpy_codec_and_twins_bitwise(kind, block):
    a = _blocks()[kind]
    qj, sj = JW.quantize_blockwise(a, block)
    qp, sp = PW.quantize_blockwise(a, block)
    assert np.array_equal(qj, qp) and np.array_equal(_u32(sj), _u32(sp))
    exc_j, exc_p = JW.nonfinite_exceptions(a), PW.nonfinite_exceptions(a)
    assert np.array_equal(_u32(exc_j), _u32(exc_p))
    dj = JW.dequantize_blockwise(qj, sj, a.size, exceptions=exc_j)
    dp = PW.dequantize_blockwise(qp, sp, a.size, exceptions=exc_p)
    assert np.array_equal(_u32(dj), _u32(dp))
    # non-finite elements come back exactly; finite ones within the bound
    finite = np.isfinite(a)
    assert np.array_equal(_u32(dp[~finite]), _u32(a[~finite]))
    bound = PW.int8_error_bound(a, block)
    assert bound == JW.int8_error_bound(a, block)
    assert np.all(np.abs(dp[finite].astype(np.float64) - a[finite]) <= bound)
    assert PW.int8_wire_bytes(a.size, block) == JW.int8_wire_bytes(a.size, block)

    # torch twin against the numpy codec (non-finite elements: 0, as the
    # traced twins quantize them)
    qt, st = PW.quantize_blockwise_jit(torch.from_numpy(a), block)
    q_np = np.where(qp == -128, np.int8(0), qp)
    assert np.array_equal(qt.numpy(), q_np) and np.array_equal(_u32(st.numpy()), _u32(sp))
    wire_t = PW.pack_wire(qt, st)
    deq_t = PW.unpack_wire(wire_t, st.numel(), block).numpy()
    # JAX twin, on what XLA's CPU sees
    src = _ftz(a) if kind == "subnormal" else a
    qjj, sjj = JW.quantize_blockwise_jit(jnp.asarray(a), block)
    qt2, st2 = PW.quantize_blockwise_jit(torch.from_numpy(src), block)
    assert np.array_equal(np.asarray(qjj), qt2.numpy())
    assert np.array_equal(_u32(np.asarray(sjj)), _u32(st2.numpy()))
    wire_j = np.asarray(JW.pack_wire(qjj, sjj))
    assert np.array_equal(wire_j, PW.pack_wire(qt2, st2).numpy())
    deq_j = np.asarray(JW.unpack_wire(jnp.asarray(wire_j), sjj.size, block))
    deq_t2 = PW.unpack_wire(torch.from_numpy(wire_j.copy()), st2.numel(), block).numpy()
    assert np.array_equal(_u32(deq_j), _u32(deq_t2))
    assert deq_t.size == st.numel() * block


def _states(seed):
    r = np.random.default_rng(seed)
    dense = r.standard_normal(4096).astype(np.float32)
    sparse = np.zeros(8192, np.float32)
    sparse[r.choice(8192, 300, replace=False)] = r.standard_normal(300).astype(np.float32)
    filled = r.uniform(0, 1, 2048).astype(np.float32)
    filled[-200:] = -np.inf  # a buffer's neutral fill
    return {
        "hist": {"counts": dense, "sparse": sparse, "n": np.int64(7)},
        "buf": {"scores": filled, "labels": r.integers(0, 2, 2048).astype(np.int64),
                "f64": r.standard_normal(300),
                "small": r.standard_normal(8).astype(np.float32)},
        "cat": {"parts": [r.standard_normal(700).astype(np.float32),
                          r.standard_normal(3).astype(np.float32)],
                "d": {"x": r.standard_normal(600).astype(np.float32), "y": np.ones(4, np.int32)}},
    }


@pytest.mark.parametrize("rung", ["exact", "bf16", "int8"])
@pytest.mark.parametrize("block", [32, 5])
def test_synclib_buffers_cross_decode_both_ways(rung, block):
    states = _states(1)
    order_j = JS.metrics_traversal_order(states)
    order_p = PS.metrics_traversal_order(states)
    assert order_j == order_p
    policy = {"hist": rung, "buf": rung, "cat": "exact" if rung == "exact" else "int8"}
    prev_j, prev_p = JC.wire_block_size(), PC.wire_block_size()
    JC.set_wire_block_size(block)
    PC.set_wire_block_size(block)
    try:
        meta_j, flat_j = JS._pack_rank_states(states, order_j, policy)
        meta_p, flat_p = PS._pack_rank_states(states, order_p, policy)
    finally:
        JC.set_wire_block_size(prev_j)
        PC.set_wire_block_size(prev_p)
    assert meta_j == meta_p
    assert np.array_equal(np.asarray(flat_j), flat_p)
    assert PS._meta_wire_tiers(order_p, [meta_p]) == JS._meta_wire_tiers(order_j, [meta_j])
    template = {m: {} for m in states}
    out_pj = PS._unpack_rank_states(template, order_p, meta_j, np.asarray(flat_j))
    out_jp = JS._unpack_rank_states(template, order_j, meta_p, flat_p)
    out_jj = JS._unpack_rank_states(template, order_j, meta_j, np.asarray(flat_j))
    for name, state in out_jj.items():
        for key, want in state.items():
            for got in (out_pj[name][key], out_jp[name][key]):
                if isinstance(want, (list, tuple)):
                    for g, w in zip(got, want):
                        assert np.asarray(g).tobytes() == np.asarray(w).tobytes()
                elif isinstance(want, dict):
                    for k in want:
                        assert np.asarray(got[k]).tobytes() == np.asarray(want[k]).tobytes()
                else:
                    assert np.asarray(got).tobytes() == np.asarray(want).tobytes()
                    assert np.asarray(got).dtype == np.asarray(want).dtype
    # integers never quantize; every rung's floats stay within its bound
    assert np.array_equal(out_pj["buf"]["labels"], states["buf"]["labels"])
    a, b = out_pj["hist"]["counts"], states["hist"]["counts"]
    err = float(np.max(np.abs(a.astype(np.float64) - b)))
    if rung == "int8":
        assert err <= PW.int8_error_bound(b, block)
    elif rung == "bf16":
        assert err <= float(np.max(np.abs(b))) * 2.0**-8
    else:
        assert err == 0.0
    assert PS.canonical_crc(order_p, meta_p, flat_p) == JS.canonical_crc(
        order_j, meta_j, np.asarray(flat_j)
    )


def _ladder_families(P, device_kw):
    r = np.random.default_rng(5)
    reps = []
    for k in range(3):
        auroc = P.BinaryAUROC(**device_kw)
        s = r.uniform(0, 1, 3000).astype(np.float32)
        y = (r.uniform(0, 1, 3000) < s).astype(np.float32)
        acc = P.MulticlassAccuracy(**device_kw)
        x = r.standard_normal((64, 5)).astype(np.float32)
        t = r.integers(0, 5, 64)
        if P is PM:
            auroc.update(torch.from_numpy(s), torch.from_numpy(y))
            acc.update(torch.from_numpy(x), torch.from_numpy(t))
        else:
            auroc.update(jnp.asarray(s), jnp.asarray(y))
            acc.update(jnp.asarray(x), jnp.asarray(t))
        reps.append({"auroc": auroc, "acc": acc})
    return reps


@pytest.mark.parametrize("rung", ["exact", "bf16", "int8"])
def test_synced_collection_stamps_wire_tier_as_jax(rung):
    from torcheval_tpu.distributed import LocalReplicaGroup as JLocal
    from torcheval_tpu.metrics import toolkit as JT

    with PC.wire_ladder_mode(rung), JC.wire_ladder_mode(rung):
        got = PT.get_synced_metric_collection(
            _ladder_families(PM, {"device": CPU}), LocalReplicaGroup([CPU] * 3)
        )
        want = JT.get_synced_metric_collection(_ladder_families(JM, {}), JLocal(["cpu"] * 3))
    for name in ("auroc", "acc"):
        assert got[name].sync_provenance.wire_tier == want[name].sync_provenance.wire_tier
        g = np.asarray(got[name].compute(), np.float64)
        w = np.asarray(want[name].compute(), np.float64)
        assert np.allclose(g, w, rtol=0, atol=1e-6)
    assert got["acc"].sync_provenance.wire_tier == "exact"  # integer counters
    assert got["auroc"].sync_provenance.wire_tier == rung


def test_ladder_steps_on_breaches_with_events(tmp_path):
    fam = "WindowedBinaryAUROC"
    rec = pobs.recorder()
    rec.reset()
    with PC.wire_ladder_mode(f"*=exact,{fam}=int8"), PC.observability(jsonl=str(tmp_path / "e.jsonl")):
        try:
            assert PW.effective_rung(fam) == "int8"
            assert PW.note_budget_breach(fam, series="s", breach="psi") == ("int8", "bf16")
            assert PW.effective_rung(fam) == "bf16" and PW.LADDER.cap(fam) == "bf16"
            assert PW.note_budget_breach(fam, series="s", breach="ks") == ("bf16", "exact")
            assert PW.note_budget_breach(fam, series="s", breach="ks") is None
            counters = PW.LADDER.counters()
            assert counters["fallback_families"] == 1 and counters[f"cap_{fam}"] == "exact"
            events = [e for e in rec.log.tail(0) if e.kind == "wire_tier"]
            assert [(e.prev_tier, e.tier) for e in events] == [("int8", "bf16"), ("bf16", "exact")]
            from torcheval_tpu_torch.obs.counters import default_registry

            assert default_registry().read()["wire"]["default_rung"] == "exact"
        finally:
            PW.LADDER.reset()
    assert PW.effective_rung(fam) == "exact"  # the scope restored the ladder
    with PC.wire_ladder_mode("int8"):
        assert PW.effective_rung(fam) == "int8"


def test_config_knobs_match_jax():
    for mod in (PC, JC):
        with mod.wire_ladder_mode("*=bf16,Cat=int8"):
            assert mod.wire_rung_for("Cat") == "int8" and mod.wire_rung_for("Max") == "bf16"
            assert mod.sync_compression() == "bf16"
        with mod.sync_compression_mode("int8"):
            assert mod.wire_ladder() == {"*": "int8"}
        with pytest.raises(ValueError):
            mod.set_wire_ladder("fp4")
        with pytest.raises(ValueError):
            mod.set_wire_block_size(1)
        with pytest.raises(ValueError):
            mod.set_failover_detect_after(0)
        with pytest.raises(ValueError):
            mod.set_federation_staleness_epochs(0)
        assert mod.wire_block_size() == 32
        assert mod.federation_staleness_epochs() == 4
        assert mod.failover_detect_after() == 2


_ENV_PROBE = (
    "import json, importlib, sys; m = importlib.import_module(sys.argv[1]); "
    "print(json.dumps([m.wire_ladder(), m.wire_block_size(), m.federation_staleness_epochs(), "
    "m.failover_detect_after(), m.sync_compression()]))"
)


@pytest.mark.parametrize("env", [
    {"TORCHEVAL_TPU_WIRE_LADDER": "*=bf16,BinaryAUROC=int8", "TORCHEVAL_TPU_WIRE_BLOCK": "16",
     "TORCHEVAL_TPU_FEDERATION_STALENESS": "7", "TORCHEVAL_TPU_FAILOVER_DETECT_AFTER": "3"},
    {"TORCHEVAL_TPU_SYNC_COMPRESSION": "int8", "TORCHEVAL_TPU_WIRE_BLOCK": "1"},
])
def test_env_vars_match_jax(env):
    full = dict(os.environ, **env, JAX_PLATFORMS="cpu")
    outs = [
        subprocess.run([sys.executable, "-W", "ignore", "-c", _ENV_PROBE, mod], env=full,
                       capture_output=True, text=True, check=True).stdout.strip().splitlines()[-1]
        for mod in ("torcheval_tpu_torch.config", "torcheval_tpu.config")
    ]
    assert outs[0] == outs[1]
