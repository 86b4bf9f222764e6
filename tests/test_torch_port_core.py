"""torcheval_tpu_torch core: the Metric base, tensor utils, input
coercion, device policy, cross-package state loading, and the package's
import rules. Inputs are made with numpy from a seed and fed to the JAX
package and to the port (``device="cpu"``)."""

from __future__ import annotations

import ast
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as JM
from torcheval_tpu.metrics.functional.tensor_utils import (
    _argmax_last_xla as jax_argmax_last,
    correct_mask as jax_correct_mask,
    nan_safe_divide as jax_nan_safe_divide,
)
import torcheval_tpu_torch.metrics as TM
from torcheval_tpu_torch.metrics.functional.tensor_utils import (
    argmax_last,
    correct_mask,
    nan_safe_divide,
    segment_sum,
)
from torcheval_tpu_torch.metrics.metric import MergeKind, Metric, UpdatePlan
from torcheval_tpu_torch.utils import load_numpy_state_dict, numpy_state_dict
from torcheval_tpu_torch.utils.convert import resolve_weight, to_torch

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"


# ------------------------------------------------------------ import rules


def _port_sources():
    files = sorted((REPO / "torcheval_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: p.name)
def test_port_imports_neither_jax_nor_the_jax_package(path):
    for mod in _imported_modules(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "flax", "torcheval_tpu"), (path, mod)


def test_fused_auc_imports_without_nvcc(tmp_path):
    """Importing the kernel modules builds and loads nothing: the CPU
    tests import every module on a machine with no CUDA toolkit."""
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_HOME=str(tmp_path))
    code = (
        "import torcheval_tpu_torch.ops.fused_auc as m, torcheval_tpu_torch.ops._kernels as k;"
        "assert not k._LOADED; print('ok')"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    from torcheval_tpu_torch.ops import _kernels

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_kernels, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_kernels, "_LOADED", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.load("fused_auc_hist")
    assert not (tmp_path / "build").exists()


# ----------------------------------------------------------------- device


def test_device_none_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None places state there")
    for make in (TM.MulticlassAccuracy, TM.Mean, TM.StreamingBinaryAUROC):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make()


def test_explicit_cpu_device_places_state_on_cpu():
    m = TM.MulticlassAccuracy(average="macro", num_classes=3, device="cpu")
    assert m.device == torch.device("cpu")
    assert m.num_correct.device.type == "cpu"


# ------------------------------------------------------------ tensor utils

_RNG = np.random.default_rng(7)


def _tricky_logits(n=64, c=9):
    x = _RNG.standard_normal((n, c)).astype(np.float32)
    x[0] = 1.0  # all tied -> first index
    x[1, 3] = np.nan  # NaN wins
    x[2, :] = -1.0
    x[2, 4] = np.nan
    x[2, 6] = np.nan  # first NaN wins
    x[3, :] = -2.0
    x[3, 2] = -0.0
    x[3, 5] = 0.0  # -0.0 ties +0.0 -> index 2
    x[4, 7] = np.inf
    x[5, :] = -np.inf
    x[6, 1] = -np.nan  # negative-signed NaN wins too
    x[7, 2] = x[7].max()  # exact tie with the max at a later index
    return x


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.float16])
def test_argmax_last_matches_jax(dtype):
    x = _tricky_logits()
    if dtype is np.int32:
        x = np.nan_to_num(x * 3, posinf=9, neginf=-9).astype(np.int32)
    else:
        x = x.astype(dtype)
    want = np.asarray(jax_argmax_last(jnp.asarray(x)))
    got = argmax_last(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_correct_mask_out_of_range_targets_never_match():
    x = _tricky_logits()
    t = _RNG.integers(-3, 12, size=x.shape[0])
    t[:8] = [0, 3, 4, 2, 7, 0, 1, 99]
    want = np.asarray(jax_correct_mask(jnp.asarray(x), jnp.asarray(t, jnp.int32)))
    got = correct_mask(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[t >= x.shape[1]].sum() == 0 and got[t < 0].sum() == 0


def test_nan_safe_divide_matches_jax():
    a = np.array([1.0, 0.0, 2.0, -3.0], np.float32)
    b = np.array([0.0, 0.0, 4.0, 7.0], np.float32)
    want = np.asarray(jax_nan_safe_divide(jnp.asarray(a), jnp.asarray(b)))
    got = nan_safe_divide(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, want)


def test_segment_sum_drops_out_of_range_ids():
    import jax

    ids = np.array([0, 2, -1, 5, 2, 4, 7], np.int64)
    data = np.arange(1, 8, dtype=np.float32)
    want = np.asarray(jax.ops.segment_sum(data, ids.astype(np.int32), num_segments=5))
    got = segment_sum(torch.from_numpy(data), torch.from_numpy(ids), 5).numpy()
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------------- convert


def test_to_torch_narrows_numpy_float64_like_the_jax_package():
    assert to_torch(np.ones(3)).dtype == torch.float32
    assert to_torch(0.5).dtype == torch.float32
    assert to_torch(np.arange(3)).dtype == torch.int64
    t = torch.ones(2, dtype=torch.float64)
    assert to_torch(t).dtype == torch.float64  # torch tensors keep their dtype


def test_resolve_weight_rejects_mismatched_tensor():
    x = torch.ones(4)
    assert resolve_weight(2, x)[0] is True
    assert resolve_weight(torch.ones(4), x)[0] is False
    with pytest.raises(ValueError, match="Weight must be"):
        resolve_weight(torch.ones(3), x)


# ------------------------------------------------------------- Metric base


class _Dummy(Metric[torch.Tensor]):
    def __init__(self, device=CPU):
        super().__init__(device=device)
        self._add_state("s", torch.zeros(3), merge=MergeKind.SUM)
        self._add_state("hi", torch.full((3,), -1.0), merge=MergeKind.MAX)
        self._add_state("lo", torch.full((3,), 9.0), merge=MergeKind.MIN)
        self._add_state("items", [], merge=MergeKind.EXTEND)
        self._add_state("count", 0, merge=MergeKind.SUM)

    def update(self, x):
        x = self._input_float(x)
        self._apply_update_plan((lambda v: v, ("s",), (x,)))
        self.hi = torch.maximum(self.hi, x)
        self.lo = torch.minimum(self.lo, x)
        self.items.append(x.clone())
        self.count += 1
        return self

    def compute(self):
        return self.s


def test_metric_plan_merge_kinds():
    a, b = _Dummy(), _Dummy()
    a.update([1.0, 5.0, 2.0])
    b.update([3.0, 0.0, 8.0])
    a.merge_state([b])
    np.testing.assert_array_equal(a.s.numpy(), [4, 5, 10])
    np.testing.assert_array_equal(a.hi.numpy(), [3, 5, 8])
    np.testing.assert_array_equal(a.lo.numpy(), [1, 0, 2])
    assert len(a.items) == 2 and a.count == 2


def test_transform_plan_replaces_states():
    m = _Dummy()
    plan = UpdatePlan(lambda states, k: (states[0] * k,), ("s",), (), (2.0,), transform=True)
    m.update([1.0, 2.0, 3.0])
    m._apply_update_plan(plan)
    np.testing.assert_array_equal(m.s.numpy(), [2, 4, 6])


def test_state_dict_is_a_copy_and_load_copies():
    m = _Dummy()
    m.update([1.0, 1.0, 1.0])
    sd = m.state_dict()
    m.s.add_(10)  # an in-place update must not reach the snapshot
    assert sd["s"].tolist() == [1.0, 1.0, 1.0]
    m2 = _Dummy()
    m2.load_state_dict(sd)
    sd["s"].add_(5)
    assert m2.s.tolist() == [1.0, 1.0, 1.0]


def test_load_state_dict_strict_keys():
    m = _Dummy()
    with pytest.raises(RuntimeError, match="missing keys"):
        m.load_state_dict({"s": torch.zeros(3)})
    m.load_state_dict({"s": torch.ones(3)}, strict=False)
    assert m.s.tolist() == [1.0, 1.0, 1.0]


def test_reset_restores_defaults():
    m = _Dummy()
    m.update([4.0, 4.0, 4.0])
    m.reset()
    assert m.s.tolist() == [0.0, 0.0, 0.0] and m.items == [] and m.count == 0
    assert m.hi.tolist() == [-1.0, -1.0, -1.0]


def test_pickle_and_to_round_trip():
    m = _Dummy()
    m.update([1.0, 2.0, 3.0])
    m2 = pickle.loads(pickle.dumps(m))
    assert m2.device == torch.device("cpu")
    np.testing.assert_array_equal(m2.s.numpy(), m.s.numpy())
    m2.to("cpu").update([1.0, 1.0, 1.0])
    assert m2.s.tolist() == [2.0, 3.0, 4.0] and m.s.tolist() == [1.0, 2.0, 3.0]


def test_state_type_validation():
    m = _Dummy()
    with pytest.raises(TypeError, match="list of"):
        m._add_state("bad", [1, 2])
    with pytest.raises(TypeError):
        m._add_state("bad", "x")


def test_throughput_merge_sums_items_over_slowest_replica():
    a = TM.Throughput(device=CPU).update(100, 2.0)
    b = TM.Throughput(device=CPU).update(50, 4.0)
    ja = JM.Throughput().update(100, 2.0)
    jb = JM.Throughput().update(50, 4.0)
    assert a.merge_state([b]).compute() == ja.merge_state([jb]).compute() == 150 / 4.0


# ------------------------------------------------- state across packages


def _state_case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    x = rng.standard_normal((200, 10)).astype(np.float32)
    y = rng.integers(0, 10, 200)
    s = rng.random(300).astype(np.float32)
    t = (rng.random(300) < s).astype(np.float32)
    return {
        "acc": (lambda P, **k: P.MulticlassAccuracy(**k), (x, y)),
        "acc_macro": (lambda P, **k: P.MulticlassAccuracy(average="macro", num_classes=10, **k), (x, y)),
        "f1_macro": (lambda P, **k: P.MulticlassF1Score(average="macro", num_classes=10, **k), (x, y)),
        "f1_none": (lambda P, **k: P.MulticlassF1Score(average=None, num_classes=10, **k), (x, y)),
        "mean": (lambda P, **k: P.Mean(**k), (x[:, 0],)),
        "sum": (lambda P, **k: P.Sum(**k), (x[:, 0],)),
        "auroc": (lambda P, **k: P.StreamingBinaryAUROC(num_bins=256, **k), (s, t)),
        "auprc": (lambda P, **k: P.StreamingBinaryAUPRC(num_bins=256, **k), (s, t)),
    }[name]


_STATE_CASES = ["acc", "acc_macro", "f1_macro", "f1_none", "mean", "sum", "auroc", "auprc"]


@pytest.mark.parametrize("name", _STATE_CASES)
def test_jax_state_loads_into_port(name):
    make, args = _state_case(name)
    jm = make(JM)
    jm.update(*args)
    tm = make(TM, device=CPU)
    load_numpy_state_dict(tm, {k: np.asarray(v) for k, v in jm.state_dict().items()})
    for k, v in jm.state_dict().items():
        np.testing.assert_array_equal(getattr(tm, k).numpy(), np.asarray(v))
        assert getattr(tm, k).numpy().dtype == np.asarray(v).dtype
    np.testing.assert_allclose(tm.compute().numpy(), np.asarray(jm.compute()), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", _STATE_CASES)
def test_port_state_loads_into_jax(name):
    make, args = _state_case(name)
    tm = make(TM, device=CPU)
    tm.update(*args)
    jm = make(JM)
    jm.load_state_dict({k: jnp.asarray(v) for k, v in numpy_state_dict(tm).items()})
    for k, v in numpy_state_dict(tm).items():
        np.testing.assert_array_equal(np.asarray(getattr(jm, k)), v)
    np.testing.assert_allclose(np.asarray(jm.compute()), tm.compute().numpy(), rtol=1e-6, atol=1e-7)


def test_throughput_state_round_trip():
    jm = JM.Throughput().update(640, 2.0)
    tm = TM.Throughput(device=CPU)
    load_numpy_state_dict(tm, jm.state_dict())
    assert tm.compute() == jm.compute()
    jm2 = JM.Throughput()
    jm2.load_state_dict(numpy_state_dict(tm))
    assert jm2.compute() == tm.compute()


def test_load_numpy_state_dict_rejects_wrong_dtype():
    tm = TM.MulticlassAccuracy(device=CPU)
    with pytest.raises(TypeError, match="float32"):
        load_numpy_state_dict(
            tm, {"num_correct": np.zeros((), np.int32), "num_total": np.zeros((), np.float32)}
        )
