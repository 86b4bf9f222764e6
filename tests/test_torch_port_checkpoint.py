"""torcheval_tpu_torch's ``utils.save_metric_state``/``load_metric_state``
against the JAX package's: round trips across every state kind (tensor
counters, growable buffers, empty buffers, floats, dicts, windowed rings,
collections), the digest, atomic publish and its recovery paths, schema
validation and the single-writer lock; plus ``_digest`` equal to the JAX
package's for the same state of every family that exists in both.

The port writes one pickle inside the checkpoint directory where the JAX
package writes Orbax, so the twins that break a checkpoint on disk
replace the pickle writer (``_write_tree``) where the JAX tests replace
the Orbax checkpointer. Values after a round trip are bitwise.
"""

from __future__ import annotations

import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as JM
from torcheval_tpu.utils import checkpoint as jckpt
import torcheval_tpu_torch.metrics as TM
import torcheval_tpu_torch.utils.checkpoint as ckpt
from torcheval_tpu_torch.metrics import (
    BinaryAUROC,
    MulticlassAccuracy,
    MulticlassConfusionMatrix,
    Throughput,
    WindowedBinaryNormalizedEntropy,
    WordErrorRate,
)
from torcheval_tpu_torch.utils import load_metric_state, load_numpy_state_dict, save_metric_state
from torcheval_tpu_torch.utils.test_utils import DummySumDictStateMetric

CPU = "cpu"
RNG = np.random.default_rng(3)


def _same(a, b):
    if isinstance(a, tuple):
        assert all(_same(x, y) for x, y in zip(a, b))
        return True
    assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    return True


def _roundtrip(tmp_path, metric, fresh):
    save_metric_state(metric, str(tmp_path / "ck"))
    load_metric_state(fresh, str(tmp_path / "ck"))
    return fresh


def test_counter_state_roundtrip(tmp_path):
    m = MulticlassAccuracy(device=CPU)
    m.update(RNG.random((16, 4)).astype(np.float32), RNG.integers(0, 4, 16))
    restored = _roundtrip(tmp_path, m, MulticlassAccuracy(device=CPU))
    _same(restored.compute(), m.compute())
    restored.update(torch.zeros((4, 4)), torch.zeros(4, dtype=torch.int32))


def test_list_buffer_state_roundtrip(tmp_path):
    m = BinaryAUROC(device=CPU)
    for _ in range(3):
        x = RNG.random(20).astype(np.float32)
        m.update(x, (RNG.random(20) < x).astype(np.float32))
    _same(_roundtrip(tmp_path, m, BinaryAUROC(device=CPU)).compute(), m.compute())


def test_empty_buffer_state_roundtrip(tmp_path):
    restored = _roundtrip(tmp_path, BinaryAUROC(device=CPU), BinaryAUROC(device=CPU))
    assert restored.num_samples == 0


def test_float_state_roundtrip(tmp_path):
    m = Throughput(device=CPU)
    m.update(100, 2.5)
    _same(_roundtrip(tmp_path, m, Throughput(device=CPU)).compute(), m.compute())


def test_host_float_text_state_roundtrip(tmp_path):
    m = WordErrorRate(device=CPU)
    m.update(["a b c"], ["a b d"])
    _same(_roundtrip(tmp_path, m, WordErrorRate(device=CPU)).compute(), m.compute())


def test_dict_state_roundtrip(tmp_path):
    m = DummySumDictStateMetric(device=CPU)
    m.update("a", torch.tensor(2.0))
    m.update("b", torch.tensor(3.0))
    restored = _roundtrip(tmp_path, m, DummySumDictStateMetric(device=CPU))
    assert restored.compute().keys() == m.compute().keys()
    for k, v in m.compute().items():
        _same(restored.compute()[k], v)
    restored.update("c", torch.tensor(1.0))


def test_window_ring_buffer_roundtrip(tmp_path):
    m = WindowedBinaryNormalizedEntropy(max_num_updates=4, device=CPU)
    for _ in range(6):
        x = np.clip(RNG.random(10), 0.01, 0.99).astype(np.float32)
        m.update(x, (RNG.random(10) < 0.5).astype(np.float32))
    restored = _roundtrip(tmp_path, m, WindowedBinaryNormalizedEntropy(max_num_updates=4, device=CPU))
    _same(restored.compute(), m.compute())


def test_collection_roundtrip(tmp_path):
    acc = MulticlassAccuracy(device=CPU)
    acc.update(RNG.random((8, 3)).astype(np.float32), RNG.integers(0, 3, 8))
    auroc = BinaryAUROC(device=CPU)
    x = RNG.random(16).astype(np.float32)
    auroc.update(x, (RNG.random(16) < x).astype(np.float32))
    save_metric_state({"acc": acc, "auroc": auroc}, str(tmp_path / "coll"))
    fresh = {"acc": MulticlassAccuracy(device=CPU), "auroc": BinaryAUROC(device=CPU)}
    load_metric_state(fresh, str(tmp_path / "coll"))
    _same(fresh["acc"].compute(), acc.compute())
    _same(fresh["auroc"].compute(), auroc.compute())


def test_collection_strict_mismatch_both_directions(tmp_path):
    acc = MulticlassAccuracy(device=CPU)
    save_metric_state({"acc": acc}, str(tmp_path / "c2"))
    with pytest.raises(RuntimeError, match="missing state for \\['other'\\]"):
        load_metric_state({"acc": MulticlassAccuracy(device=CPU), "other": BinaryAUROC(device=CPU)},
                          str(tmp_path / "c2"))
    save_metric_state({"acc": acc, "extra": MulticlassAccuracy(device=CPU)}, str(tmp_path / "c3"))
    with pytest.raises(RuntimeError, match="unclaimed saved state"):
        load_metric_state({"acc": MulticlassAccuracy(device=CPU)}, str(tmp_path / "c3"))
    load_metric_state({"acc": MulticlassAccuracy(device=CPU), "other": BinaryAUROC(device=CPU)},
                      str(tmp_path / "c2"), strict=False)


def test_single_vs_collection_kind_mismatch(tmp_path):
    acc = MulticlassAccuracy(device=CPU)
    save_metric_state({"acc": acc}, str(tmp_path / "coll"))
    with pytest.raises(RuntimeError, match="holds a metric collection"):
        load_metric_state(MulticlassAccuracy(device=CPU), str(tmp_path / "coll"))
    save_metric_state(acc, str(tmp_path / "single"))
    with pytest.raises(RuntimeError, match="holds a single metric"):
        load_metric_state({"acc": MulticlassAccuracy(device=CPU)}, str(tmp_path / "single"))


def test_reserved_digest_name_is_rejected(tmp_path):
    with pytest.raises(ValueError, match="reserved"):
        save_metric_state({"__digest__": MulticlassAccuracy(device=CPU)}, str(tmp_path / "x"))


# ------------------------------------------------------------ fault tolerance


def _feed_acc(m):
    m.update(RNG.random((16, 4)).astype(np.float32), RNG.integers(0, 4, 16))
    return m


def _victim(path):
    return max((p for p in path.rglob("*") if p.is_file()), key=lambda p: p.stat().st_size)


def test_corrupt_checkpoint_rejected_with_clear_error(tmp_path):
    path = tmp_path / "ck"
    save_metric_state(_feed_acc(MulticlassAccuracy(device=CPU)), str(path))
    victim = _victim(path)
    blob = bytearray(victim.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    victim.write_bytes(bytes(blob))
    with pytest.raises(RuntimeError, match="corrupt"):
        load_metric_state(MulticlassAccuracy(device=CPU), str(path))


def test_truncated_checkpoint_rejected(tmp_path):
    path = tmp_path / "ck"
    save_metric_state(_feed_acc(MulticlassAccuracy(device=CPU)), str(path))
    victim = _victim(path)
    victim.write_bytes(victim.read_bytes()[: victim.stat().st_size // 2])
    with pytest.raises(RuntimeError, match="corrupt"):
        load_metric_state(MulticlassAccuracy(device=CPU), str(path))


def test_missing_file_is_a_clear_error_not_garbage(tmp_path):
    path = tmp_path / "ck"
    save_metric_state(_feed_acc(MulticlassAccuracy(device=CPU)), str(path))
    _victim(path).unlink()
    with pytest.raises(RuntimeError, match="corrupt or truncated"):
        load_metric_state(MulticlassAccuracy(device=CPU), str(path))


def test_save_is_atomic_under_mid_write_failure(tmp_path, monkeypatch):
    first = _feed_acc(MulticlassAccuracy(device=CPU))
    path = tmp_path / "ck"
    save_metric_state(first, str(path))

    def exploding(directory, tree):
        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, "partial"), "w") as f:
            f.write("torn")
        raise RuntimeError("disk full")

    monkeypatch.setattr(ckpt, "_write_tree", exploding)
    with pytest.raises(RuntimeError, match="disk full"):
        save_metric_state(_feed_acc(MulticlassAccuracy(device=CPU)), str(path))
    monkeypatch.undo()
    _same(load_metric_state(MulticlassAccuracy(device=CPU), str(path)).compute(), first.compute())


def test_overwrite_save_roundtrips(tmp_path):
    path = tmp_path / "ck"
    save_metric_state(_feed_acc(MulticlassAccuracy(device=CPU)), str(path))
    newer = _feed_acc(MulticlassAccuracy(device=CPU))
    save_metric_state(newer, str(path))
    _same(load_metric_state(MulticlassAccuracy(device=CPU), str(path)).compute(), newer.compute())
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ck"]


def test_legacy_checkpoint_without_digest_still_loads(tmp_path):
    m = _feed_acc(MulticlassAccuracy(device=CPU))
    path = tmp_path / "ck"
    save_metric_state(m, str(path))
    tree = ckpt._read_tree(str(path))
    tree.pop("__digest__")
    (path / ckpt._TREE_FILE).write_bytes(pickle.dumps(tree))
    _same(load_metric_state(MulticlassAccuracy(device=CPU), str(path)).compute(), m.compute())


def test_missing_checkpoint_is_file_not_found(tmp_path):
    with pytest.raises(FileNotFoundError, match="no metric checkpoint"):
        load_metric_state(MulticlassAccuracy(device=CPU), str(tmp_path / "never"))


def _failing_tmp_rename(monkeypatch):
    real_rename = os.rename

    def failing_rename(src, dst):
        if src.endswith(".tmp"):
            raise OSError("simulated rename failure")
        return real_rename(src, dst)

    monkeypatch.setattr(ckpt.os, "rename", failing_rename)


def test_overwrite_failure_rolls_previous_checkpoint_back(tmp_path, monkeypatch):
    first = _feed_acc(MulticlassAccuracy(device=CPU))
    path = tmp_path / "ck"
    save_metric_state(first, str(path))
    _failing_tmp_rename(monkeypatch)
    with pytest.raises(OSError, match="simulated"):
        save_metric_state(_feed_acc(MulticlassAccuracy(device=CPU)), str(path))
    monkeypatch.undo()
    _same(load_metric_state(MulticlassAccuracy(device=CPU), str(path)).compute(), first.compute())


def test_save_after_interrupted_save_preserves_aside_snapshot(tmp_path, monkeypatch):
    m = _feed_acc(MulticlassAccuracy(device=CPU))
    path = tmp_path / "ck"
    save_metric_state(m, str(path))
    os.rename(str(path), str(path) + ".old")
    _failing_tmp_rename(monkeypatch)
    with pytest.raises(OSError, match="simulated"):
        save_metric_state(_feed_acc(MulticlassAccuracy(device=CPU)), str(path))
    monkeypatch.undo()
    _same(load_metric_state(MulticlassAccuracy(device=CPU), str(path)).compute(), m.compute())


def test_crash_between_swap_renames_recovers_from_aside(tmp_path):
    m = _feed_acc(MulticlassAccuracy(device=CPU))
    path = tmp_path / "ck"
    save_metric_state(m, str(path))
    os.rename(str(path), str(path) + ".old")
    _same(load_metric_state(MulticlassAccuracy(device=CPU), str(path)).compute(), m.compute())
    assert os.path.exists(str(path))


def test_empty_buffer_digest_roundtrip(tmp_path):
    path = tmp_path / "ck"
    save_metric_state(BinaryAUROC(device=CPU), str(path))
    tree = ckpt._read_tree(str(path))
    assert set(tree["__single__"]["inputs"]) == {"__empty_shape__", "__empty_proto__"}
    assert load_metric_state(BinaryAUROC(device=CPU), str(path)).num_samples == 0


def test_window_cursor_survives_resume(tmp_path):
    rng = np.random.default_rng(8)
    batches = [(np.clip(rng.random(10), 0.01, 0.99).astype(np.float32),
                (rng.random(10) < 0.5).astype(np.float32)) for _ in range(10)]
    uninterrupted = WindowedBinaryNormalizedEntropy(max_num_updates=4, device=CPU)
    first = WindowedBinaryNormalizedEntropy(max_num_updates=4, device=CPU)
    for x, t in batches[:6]:
        uninterrupted.update(x, t)
        first.update(x, t)
    save_metric_state(first, str(tmp_path / "cursor"))
    resumed = load_metric_state(WindowedBinaryNormalizedEntropy(max_num_updates=4, device=CPU),
                                str(tmp_path / "cursor"))
    assert resumed.next_inserted == first.next_inserted == 2
    for x, t in batches[6:]:
        uninterrupted.update(x, t)
        resumed.update(x, t)
    _same(resumed.compute(), uninterrupted.compute())


def test_mismatched_shape_fails_naming_the_leaf(tmp_path):
    m = MulticlassConfusionMatrix(4, device=CPU)
    m.update(RNG.random((8, 4)).astype(np.float32), RNG.integers(0, 4, 8))
    save_metric_state(m, str(tmp_path / "cm"))
    with pytest.raises(RuntimeError, match=r"state 'confusion_matrix' holds int32\[4, 4\] but "
                       r"MulticlassConfusionMatrix registered int32\[8, 8\]"):
        load_metric_state(MulticlassConfusionMatrix(8, device=CPU), str(tmp_path / "cm"))


def test_mismatched_collection_leaf_names_metric_prefix(tmp_path):
    save_metric_state({"cm": MulticlassConfusionMatrix(4, device=CPU)}, str(tmp_path / "coll"))
    with pytest.raises(RuntimeError, match="state 'cm.confusion_matrix'"):
        load_metric_state({"cm": MulticlassConfusionMatrix(3, device=CPU)}, str(tmp_path / "coll"))


def test_kind_mismatch_fails_clearly(tmp_path):
    m = Throughput(device=CPU)
    m.update(100, 2.5)
    path = tmp_path / "tp"
    save_metric_state(m, str(path))
    tree = ckpt._read_tree(str(path))
    tree["__single__"]["num_total"] = np.zeros(3, np.float32)
    tree.pop("__digest__")
    (path / ckpt._TREE_FILE).write_bytes(pickle.dumps(tree))
    with pytest.raises(RuntimeError, match="'num_total' holds 'ndarray' but Throughput"):
        load_metric_state(Throughput(device=CPU), str(path))


def test_growable_buffer_shapes_still_load(tmp_path):
    m = BinaryAUROC(device=CPU)
    x = RNG.random(100).astype(np.float32)
    m.update(x, (RNG.random(100) < x).astype(np.float32))
    _same(_roundtrip(tmp_path, m, BinaryAUROC(device=CPU)).compute(), m.compute())


def test_concurrent_writer_to_same_path_fails_loudly(tmp_path):
    m = _feed_acc(MulticlassAccuracy(device=CPU))
    path = tmp_path / "ck"
    with open(str(path) + ".lock", "w") as f:
        f.write("pid=other t=now\n")
    with pytest.raises(RuntimeError, match="another save_metric_state writer"):
        save_metric_state(m, str(path))
    assert not path.exists()
    save_metric_state(m, str(tmp_path / "other"))


def test_stale_lock_from_crashed_writer_is_broken(tmp_path):
    m = _feed_acc(MulticlassAccuracy(device=CPU))
    path = tmp_path / "ck"
    lock = str(path) + ".lock"
    with open(lock, "w") as f:
        f.write("pid=dead\n")
    old = os.path.getmtime(lock) - ckpt._LOCK_STALE_SECONDS - 10
    os.utime(lock, (old, old))
    with pytest.warns(RuntimeWarning, match="breaking stale checkpoint lock"):
        save_metric_state(m, str(path))
    _same(load_metric_state(MulticlassAccuracy(device=CPU), str(path)).compute(), m.compute())
    assert not os.path.exists(lock)


def test_lock_released_after_failed_save(tmp_path, monkeypatch):
    def exploding(directory, tree):
        raise RuntimeError("disk full")

    monkeypatch.setattr(ckpt, "_write_tree", exploding)
    m = _feed_acc(MulticlassAccuracy(device=CPU))
    with pytest.raises(RuntimeError, match="disk full"):
        save_metric_state(m, str(tmp_path / "ck"))
    monkeypatch.undo()
    assert not os.path.exists(str(tmp_path / "ck") + ".lock")
    save_metric_state(m, str(tmp_path / "ck"))


def test_lock_protocol_constants_match_jax():
    assert ckpt._LOCK_STALE_SECONDS == jckpt._LOCK_STALE_SECONDS
    assert ckpt._DIGEST_KEY == jckpt._DIGEST_KEY


# --------------------------------------------------- digests across packages


def _pair(name, kw=None, feed=None):
    """A JAX metric fed by ``feed`` and a port metric holding the same
    state (cross-loaded, so float sums computed in another order cannot
    make the states differ)."""
    kw = kw or {}
    j = getattr(JM, name)(**kw)
    t = getattr(TM, name)(device=CPU, **kw)
    if feed is not None:
        feed(j)
        load_numpy_state_dict(t, {k: np.asarray(v) if not isinstance(v, (int, float, list)) else v
                                  for k, v in j.state_dict().items()})
    return j, t


def _feed_binary(m):
    rng = np.random.default_rng(11)
    for _ in range(3):
        x = rng.random(24).astype(np.float32)
        m.update(x, (rng.random(24) < x).astype(np.float32))


def _feed_classes(m):
    rng = np.random.default_rng(12)
    m.update(rng.random((32, 5)).astype(np.float32), rng.integers(0, 5, 32))


def _feed_text(m):
    m.update(["the cat sat", "a b c d"], ["the cat sat down", "a b x d"])


def _feed_throughput(m):
    m.update(640, 2.5)


DIGEST_CASES = {
    "counters": ("MulticlassAccuracy", None, _feed_classes),
    "confusion_matrix": ("MulticlassConfusionMatrix", {"num_classes": 5}, _feed_classes),
    "histogram": ("StreamingBinaryAUROC", {"num_bins": 64}, _feed_binary),
    "buffer": ("BinaryAUROC", None, _feed_binary),
    "empty_buffer": ("BinaryAUROC", None, None),
    "window_counters": ("WindowedBinaryNormalizedEntropy", {"max_num_updates": 2}, _feed_binary),
    "window_buffer": ("WindowedBinaryAUROC", {"max_num_samples": 32}, _feed_binary),
    "python_scalars": ("Throughput", None, _feed_throughput),
    "text": ("WordErrorRate", None, _feed_text),
    "ne": ("BinaryNormalizedEntropy", None, _feed_binary),
}


@pytest.mark.parametrize("case", sorted(DIGEST_CASES))
def test_digest_matches_jax_for_the_same_state(case, tmp_path):
    name, kw, feed = DIGEST_CASES[case]
    j, t = _pair(name, kw, feed)
    jplain = jckpt._to_plain(j.state_dict())
    tplain = ckpt._to_plain(t.state_dict())
    assert ckpt._digest(ckpt._from_plain(tplain)) == jckpt._digest(jckpt._from_plain(jplain))
    # the plain trees pickle to the same bytes, as the elastic shards need
    assert pickle.dumps(tplain, protocol=pickle.HIGHEST_PROTOCOL) == pickle.dumps(
        jplain, protocol=pickle.HIGHEST_PROTOCOL)
    # and the digest a saved checkpoint carries is the same
    save_metric_state(t, str(tmp_path / "t"))
    jckpt.save_metric_state(j, str(tmp_path / "j"))
    tstored = ckpt._read_tree(str(tmp_path / "t"))["__digest__"]
    jstored = jckpt._checkpointer().restore(str(tmp_path / "j"))["__digest__"]
    assert bytes(np.asarray(tstored)) == bytes(np.asarray(jstored))


def test_digest_sees_every_leaf_and_path():
    base = {"a": np.zeros(3, np.float32), "b": [np.ones(2, np.int32)], "c": 3}
    d = ckpt._digest(base)
    assert d == jckpt._digest(base)
    for mutated in ({**base, "a": np.zeros(3, np.float64)}, {**base, "c": 4},
                    {**base, "b": [np.ones((1, 2), np.int32)]}, {"a2": base["a"], "b": base["b"],
                                                                 "c": 3}):
        assert ckpt._digest(mutated) != d
        assert ckpt._digest(mutated) == jckpt._digest(mutated)
    assert ckpt._digest({"x": torch.arange(3, dtype=torch.int32)}) == jckpt._digest(
        {"x": jnp.arange(3, dtype=jnp.int32)})


def test_state_crosses_packages_through_a_checkpoint_tree(tmp_path):
    """The two checkpoint formats differ, but the saved tree of either
    loads into the other package's metric through ``load_state_dict``."""
    j, t = _pair("BinaryAUROC", None, _feed_binary)
    save_metric_state(t, str(tmp_path / "t"))
    tree = ckpt._from_plain(ckpt._read_tree(str(tmp_path / "t")))["__single__"]
    fresh = JM.BinaryAUROC()
    fresh.load_state_dict({k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                           for k, v in tree.items()})
    np.testing.assert_allclose(np.asarray(fresh.compute()), np.asarray(j.compute()), rtol=1e-6)
