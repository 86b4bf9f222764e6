"""Parity faults C4-C8 of the port against the JAX package (ROADMAP
Queue C), each pinned by the failure it had: half-precision states that
narrowed, bfloat16 that could not cross numpy, float64 inputs that were
not narrowed, error types that differed, and the kernel loader's race.
Inputs are made with numpy from a seed and fed to both packages
(``device="cpu"`` here)."""

from __future__ import annotations

import os
import stat
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as JM
import torcheval_tpu.metrics.functional as JF
from torcheval_tpu.analysis.concurrency import check_concurrency
from torcheval_tpu.distributed import LocalReplicaGroup as JaxLocalGroup
from torcheval_tpu.metrics import toolkit as jax_toolkit

import torcheval_tpu_torch.metrics as TM
import torcheval_tpu_torch.metrics.functional as TF
from torcheval_tpu_torch.distributed import LocalReplicaGroup
from torcheval_tpu_torch.elastic import ElasticSession
from torcheval_tpu_torch.metrics import toolkit
from torcheval_tpu_torch.ops import _kernels
from torcheval_tpu_torch.utils import load_numpy_state_dict, numpy_state_dict
from torcheval_tpu_torch.utils.checkpoint import load_metric_state, save_metric_state

CPU = "cpu"
REPO = Path(__file__).resolve().parents[1]
HALF = {"float16": (torch.float16, jnp.float16), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# relative tolerance of the accumulated values: each update's sums are
# rounded once to the input dtype in both packages, and the two round at
# different points (torch after a float32 sum, XLA inside its fusion)
HALF_RTOL = {"float16": 2e-3, "bfloat16": 1.6e-2}


def _jax_np(state):
    return {k: np.asarray(v) for k, v in state.items()}


# -------------------------------------------------------------------- C4


def _half_stream(dtype_name, seed, updates=50, rows=4096):
    rng = np.random.default_rng(seed)
    return [
        (rng.random((rows, 2), np.float32), rng.random((rows, 2), np.float32))
        for _ in range(updates)
    ]


@pytest.mark.parametrize("dtype_name", sorted(HALF))
@pytest.mark.parametrize("family", ["mse", "r2"])
def test_half_precision_multioutput_states_stay_float32(dtype_name, family):
    tdt, jdt = HALF[dtype_name]
    if family == "mse":
        port = TM.MeanSquaredError(multioutput="raw_values", device=CPU)
        ref = JM.MeanSquaredError(multioutput="raw_values")
    else:
        port = TM.R2Score(multioutput="raw_values", device=CPU)
        ref = JM.R2Score(multioutput="raw_values")
    for x, y in _half_stream(dtype_name, seed=4):
        port.update(torch.from_numpy(x).to(tdt), torch.from_numpy(y).to(tdt))
        ref.update(jnp.asarray(x).astype(jdt), jnp.asarray(y).astype(jdt))
    for name, value in port.state_dict().items():
        want = np.asarray(getattr(ref, name))
        assert value.dtype == torch.float32, (name, value.dtype)
        assert want.dtype == np.float32
        np.testing.assert_allclose(value.numpy(), want, rtol=HALF_RTOL[dtype_name])
    got, want = port.compute().numpy(), np.asarray(ref.compute())
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=HALF_RTOL[dtype_name] * 10)
    # the JAX state loads into the updated port metric (dtypes agree)
    load_numpy_state_dict(port, _jax_np(ref.state_dict()))
    np.testing.assert_array_equal(port.compute().numpy(), np.asarray(ref.compute()))


@pytest.mark.parametrize("dtype_name", sorted(HALF))
@pytest.mark.parametrize("fn", ["mean_squared_error", "r2_score"])
def test_half_precision_multioutput_functionals_return_float32(dtype_name, fn):
    tdt, jdt = HALF[dtype_name]
    x, y = _half_stream(dtype_name, seed=5, updates=1, rows=512)[0]
    got = getattr(TF, fn)(
        torch.from_numpy(x).to(tdt), torch.from_numpy(y).to(tdt),
        multioutput="raw_values", device=CPU,
    )
    want = getattr(JF, fn)(
        jnp.asarray(x).astype(jdt), jnp.asarray(y).astype(jdt), multioutput="raw_values"
    )
    assert got.dtype == torch.float32 and np.asarray(want).dtype == np.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=HALF_RTOL[dtype_name] * 10)


# -------------------------------------------------------------------- C5


def _bf16_auroc_replicas(seed):
    rng = np.random.default_rng(seed)
    scores = rng.random((4, 16), np.float32)
    labels = (rng.random((4, 16)) > 0.5).astype(np.float32)
    port = [TM.BinaryAUROC(device=CPU) for _ in range(4)]
    ref = [JM.BinaryAUROC() for _ in range(4)]
    for i in range(4):
        port[i].update(torch.from_numpy(scores[i]).to(torch.bfloat16), torch.from_numpy(labels[i]))
        ref[i].update(jnp.asarray(scores[i]).astype(jnp.bfloat16), jnp.asarray(labels[i]))
    return port, ref


def test_bfloat16_states_sync_over_local_replicas_to_the_jax_value():
    port, ref = _bf16_auroc_replicas(seed=11)
    got = toolkit.sync_and_compute(port, LocalReplicaGroup([CPU] * 4))
    want = jax_toolkit.sync_and_compute(ref, JaxLocalGroup(jax.devices("cpu")[:1] * 4))
    assert float(got) == float(want)
    synced = toolkit.get_synced_metric(port, LocalReplicaGroup([CPU] * 4))
    assert synced.inputs.dtype == torch.bfloat16


def test_bfloat16_states_cross_load_both_ways():
    port, ref = _bf16_auroc_replicas(seed=12)
    out = numpy_state_dict(port[0])
    assert out["inputs"].dtype == np.dtype(ml_dtypes.bfloat16)
    assert out["inputs"].tobytes() == np.asarray(ref[0].inputs).tobytes()
    into_jax = JM.BinaryAUROC()
    into_jax.load_state_dict({k: jnp.asarray(v) for k, v in out.items()})
    assert float(into_jax.compute()) == float(ref[0].compute())
    into_port = TM.BinaryAUROC(device=CPU)
    load_numpy_state_dict(into_port, _jax_np(ref[1].state_dict()))
    assert into_port.inputs.dtype == torch.bfloat16
    assert float(into_port.compute()) == float(ref[1].compute())


def test_bfloat16_states_survive_checkpoint_and_elastic_snapshot(tmp_path):
    port, _ = _bf16_auroc_replicas(seed=13)
    save_metric_state(port[0], str(tmp_path / "ckpt"))
    loaded = TM.BinaryAUROC(device=CPU)
    load_metric_state(loaded, str(tmp_path / "ckpt"))
    assert torch.equal(loaded.inputs.view(torch.int16), port[0].inputs.view(torch.int16))
    assert loaded.inputs.dtype == torch.bfloat16

    session = ElasticSession({"auroc": port[1]}, str(tmp_path / "elastic"), interval=1)
    session.step_done(0)
    session.close()
    fresh = {"auroc": TM.BinaryAUROC(device=CPU)}
    restored = ElasticSession(fresh, str(tmp_path / "elastic"), interval=1)
    assert restored.restore() is not None
    assert fresh["auroc"].inputs.dtype == torch.bfloat16
    assert torch.equal(
        fresh["auroc"].inputs.view(torch.int16), port[1].inputs.view(torch.int16)
    )
    restored.close()


# -------------------------------------------------------------------- C6


def _f64(seed, shape=(64,)):
    return np.random.default_rng(seed).random(shape)  # float64


@pytest.mark.parametrize(
    "name, call, oracle",
    [
        ("sum", lambda x, y: TF.sum(torch.from_numpy(x), device=CPU), lambda x, y: x.sum()),
        ("mean", lambda x, y: TF.mean(torch.from_numpy(x), device=CPU), lambda x, y: x.mean()),
        (
            "mean_squared_error",
            lambda x, y: TF.mean_squared_error(torch.from_numpy(x), torch.from_numpy(y), device=CPU),
            lambda x, y: ((x - y) ** 2).mean(),
        ),
        (
            "r2_score",
            lambda x, y: TF.r2_score(torch.from_numpy(x), torch.from_numpy(y), device=CPU),
            lambda x, y: 1 - ((y - x) ** 2).sum() / ((y - y.mean()) ** 2).sum(),
        ),
        (
            "peak_signal_noise_ratio",
            lambda x, y: TF.peak_signal_noise_ratio(
                torch.from_numpy(x), torch.from_numpy(y), data_range=1.0, device=CPU
            ),
            lambda x, y: 10 * np.log10(1.0 / ((x - y) ** 2).mean()),
        ),
        (
            "auc",
            lambda x, y: TF.auc(torch.from_numpy(np.sort(x)), torch.from_numpy(y), device=CPU),
            lambda x, y: np.trapezoid(y, np.sort(x)),
        ),
    ],
)
def test_float64_inputs_narrow_to_float32_in_functionals(name, call, oracle):
    x, y = _f64(1), _f64(2)
    got = call(x, y)
    assert got.dtype == torch.float32, name
    np.testing.assert_allclose(got.numpy().reshape(-1)[0], oracle(x, y), rtol=2e-5)


@pytest.mark.parametrize(
    "make, args, states",
    [
        (lambda: TM.Sum(device=CPU), 1, ("weighted_sum",)),
        (lambda: TM.Mean(device=CPU), 1, ("weighted_sum", "weights")),
        (lambda: TM.Max(device=CPU), 1, ("max",)),
        (lambda: TM.Min(device=CPU), 1, ("min",)),
        (lambda: TM.MeanSquaredError(device=CPU), 2, ("sum_squared_error", "sum_weight")),
        (lambda: TM.R2Score(device=CPU), 2, ("sum_squared_obs", "sum_obs", "sum_squared_residual")),
        (lambda: TM.PeakSignalNoiseRatio(data_range=1.0, device=CPU), 2, ("sum_squared_error",)),
    ],
    ids=["Sum", "Mean", "Max", "Min", "MeanSquaredError", "R2Score", "PeakSignalNoiseRatio"],
)
def test_float64_inputs_narrow_to_float32_in_classes(make, args, states):
    metric = make()
    batches = [(_f64(10 + i), _f64(20 + i)) for i in range(3)]
    for x, y in batches:
        metric.update(*[torch.from_numpy(a) for a in (x, y)[:args]])
    for name in states:
        assert getattr(metric, name).dtype == torch.float32, name
    assert metric.compute().dtype == torch.float32
    x = np.concatenate([b[0] for b in batches])
    y = np.concatenate([b[1] for b in batches])
    oracle = {
        "Sum": x.sum(),
        "Mean": x.mean(),
        "Max": x.max(),
        "Min": x.min(),
        "MeanSquaredError": ((x - y) ** 2).mean(),
        "R2Score": 1 - ((y - x) ** 2).sum() / ((y - y.mean()) ** 2).sum(),
        "PeakSignalNoiseRatio": 10 * np.log10(1.0 / ((x - y) ** 2).mean()),
    }[type(metric).__name__]
    np.testing.assert_allclose(float(metric.compute()), oracle, rtol=2e-5)


# -------------------------------------------------------------------- C7


def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the type is what is compared
        return type(e)
    return None


@pytest.mark.parametrize(
    "port_call, jax_call",
    [
        (
            lambda: TF.mean_squared_error(torch.tensor(1.0), torch.tensor(2.0), device=CPU),
            lambda: JF.mean_squared_error(np.float32(1.0), np.float32(2.0)),
        ),
        (
            lambda: TF.r2_score(torch.tensor(1.0), torch.tensor(2.0), device=CPU),
            lambda: JF.r2_score(np.float32(1.0), np.float32(2.0)),
        ),
        (
            lambda: TM.MeanSquaredError(device=CPU).update(torch.tensor(1.0), torch.tensor(2.0)),
            lambda: JM.MeanSquaredError().update(np.float32(1.0), np.float32(2.0)),
        ),
        (
            lambda: TM.R2Score(device=CPU).update(torch.tensor(1.0), torch.tensor(2.0)),
            lambda: JM.R2Score().update(np.float32(1.0), np.float32(2.0)),
        ),
        (
            lambda: TF.auc(torch.tensor([True, False]), torch.tensor([True, True]), device=CPU),
            lambda: JF.auc(np.array([True, False]), np.array([True, True])),
        ),
    ],
    ids=["mse-0d", "r2-0d", "MSE-0d", "R2-0d", "auc-bool"],
)
def test_error_types_match_jax(port_call, jax_call):
    want = _raised(jax_call)
    assert want is not None
    assert _raised(port_call) is want


def test_auc_of_bool_y_computes_like_jax():
    # only x is subtracted: a bool y is a value in both packages
    x, y = np.array([0.0, 0.5, 1.0], np.float32), np.array([True, False, True])
    got = TF.auc(torch.from_numpy(x), torch.from_numpy(y), device=CPU)
    np.testing.assert_array_equal(got.numpy(), np.asarray(JF.auc(x, y)))


# -------------------------------------------------------------------- C8


def test_concurrency_verifier_reports_no_active_finding_over_the_port():
    report = check_concurrency([str(REPO / "torcheval_tpu_torch")], record=False)
    assert report.checked > 0
    assert report.active == [], [f.format() for f in report.active]


class _FakeLibrary:
    """Stands in for the built ``.so``: every symbol is a no-op."""

    def __init__(self, path):
        self.path = path

    def __getattr__(self, name):
        fn = lambda *a: 0  # noqa: E731
        self.__dict__[name] = fn
        return fn


def test_two_threads_racing_a_cold_load_run_one_build(tmp_path, monkeypatch):
    count = tmp_path / "builds"
    stub = tmp_path / "nvcc"
    stub.write_text(
        "#!/bin/sh\n"
        f'echo build >> "{count}"\n'
        "sleep 0.3\n"
        'while [ $# -gt 0 ]; do [ "$1" = "-o" ] && out="$2"; shift; done\n'
        'echo stub > "$out"\n'
    )
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_kernels, "_nvcc", lambda: str(stub))
    monkeypatch.setattr(_kernels, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_kernels, "_LOADED", {})
    monkeypatch.setattr(_kernels.ctypes, "CDLL", _FakeLibrary)
    barrier = threading.Barrier(2)
    libs, errors = [], []

    def racer():
        barrier.wait()
        try:
            libs.append(_kernels.load("fused_auc_hist"))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=racer) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert count.read_text().count("build") == 1
    assert len(libs) == 2 and libs[0] is libs[1]
    built = sorted(p.name for p in (tmp_path / "build").iterdir())
    # one library and its log, no temporaries left behind
    assert len(built) == 2 and not any(".tmp" in n for n in built), built
    assert os.path.exists(_kernels._library_path("fused_auc_hist"))
