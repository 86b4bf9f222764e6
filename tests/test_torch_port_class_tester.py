"""The port's per-class contract harness (``utils/test_utils``) over the
recommendation-eval classes, ``Sum``, ``Mean`` and the dummy metrics:
state registry, pickle, the ``state_dict`` round trip, update/compute
idempotence, a merge over 4 simulated replicas and a ``LocalReplicaGroup``
sync. Expected values come from the JAX package fed the same numpy
batches: one metric over the whole stream, and a merge of 4 JAX replicas
for the merged value (a merged ranking may break ties in another order
than one stream).
"""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as JM
from torcheval_tpu.utils import test_utils as jtest_utils
import torcheval_tpu_torch.metrics as TM
from torcheval_tpu_torch.utils.test_utils import (
    DummySumDictStateMetric,
    DummySumListStateMetric,
    DummySumMetric,
    MetricClassTester,
    assert_result_close,
)

CPU = "cpu"
N = 8  # updates
WORLD = 4


def _stream(seed, make_batch):
    rng = np.random.default_rng(seed)
    batches = [make_batch(rng, i) for i in range(N)]
    return {name: [b[name] for b in batches] for name in batches[0]}


def _probs(rng, i, tasks=1):
    shape = (16 + i,) if tasks == 1 else (tasks, 16 + i)
    p = rng.random(shape).astype(np.float32)
    return p, (rng.random(shape) < p).astype(np.float32)


def _ne_batch(rng, i):
    p, y = _probs(rng, i, 2)
    return {"input": p, "target": y, "weight": rng.random(p.shape).astype(np.float32)}


def _ctr_batch(rng, i):
    _, y = _probs(rng, i)
    return {"input": y, "weights": rng.random(y.shape).astype(np.float32)}


def _wc_batch(rng, i):
    p, y = _probs(rng, i)
    return {"input": p, "target": y, "task_ids": rng.integers(-1, 4, p.shape)}


def _rank_batch(rng, i):
    x = np.round(rng.random((10, 6)) * 4).astype(np.float32) / 4
    return {"input": x, "target": rng.integers(-6, 8, 10)}


def _rp_batch(rng, i):
    x = np.round(rng.random(30) * 5).astype(np.float32) / 5
    return {"input": x, "target": (rng.random(30) < 0.3).astype(np.float32),
            "indexes": rng.integers(-1, 5, 30)}


def _sum_batch(rng, i):
    return {"input": rng.random(7).astype(np.float32),
            "weight": rng.random(7).astype(np.float32)}


# name -> (constructor given the package and device kwargs, batch maker, state names)
CASES = {
    "binary_normalized_entropy": (
        lambda P, **k: P.BinaryNormalizedEntropy(num_tasks=2, **k), _ne_batch,
        {"total_entropy", "num_examples", "num_positive"}),
    "click_through_rate": (lambda P, **k: P.ClickThroughRate(**k), _ctr_batch,
                           {"click_total", "weight_total"}),
    "weighted_calibration": (lambda P, **k: P.WeightedCalibration(num_tasks=4, **k), _wc_batch,
                             {"weighted_input_sum", "weighted_target_sum"}),
    "hit_rate": (lambda P, **k: P.HitRate(k=2, **k), _rank_batch, {"scores", "_num_samples"}),
    "reciprocal_rank": (lambda P, **k: P.ReciprocalRank(k=4, **k), _rank_batch,
                        {"scores", "_num_samples"}),
    "retrieval_precision": (lambda P, **k: P.RetrievalPrecision(
        "skip", k=3, num_queries=5, **k), _rp_batch, {"topk", "target"}),
    "sum": (lambda P, **k: P.Sum(**k), _sum_batch, {"weighted_sum"}),
    "mean": (lambda P, **k: P.Mean(**k), _sum_batch, {"weighted_sum", "weights"}),
}


def _jax_expected(make, kwargs):
    """(whole-stream value, merge of WORLD replicas in rank order) from the
    JAX package."""
    def feed(m, indices):
        for i in indices:
            m.update(**{k: v[i] for k, v in kwargs.items()})
        return m

    whole = feed(make(JM), range(N)).compute()
    per = N // WORLD
    ranks = [feed(make(JM), range(r * per, (r + 1) * per)) for r in range(WORLD)]
    ranks[0].merge_state(ranks[1:])
    return np.asarray(whole), np.asarray(ranks[0].compute())


class TestRecommendationClasses(MetricClassTester):
    @pytest.mark.parametrize("name", sorted(CASES))
    def test_class_contract(self, name):
        make, batch, states = CASES[name]
        kwargs = _stream(sorted(CASES).index(name), batch)
        whole, merged = _jax_expected(make, kwargs)
        self.run_class_implementation_tests(
            metric=make(TM, device=CPU),
            state_names=states,
            update_kwargs=kwargs,
            compute_result=whole,
            merge_and_compute_result=merged,
            num_total_updates=N,
            num_processes=WORLD,
            atol=1e-6,
            rtol=1e-6,
        )


class TestDummyMetrics(MetricClassTester):
    def test_dummy_sum(self):
        values = [np.float32(v) for v in np.linspace(0.5, 4.0, N)]
        self.run_class_implementation_tests(
            metric=DummySumMetric(device=CPU), state_names={"sum"},
            update_kwargs={"x": values}, compute_result=np.sum(values))

    def test_dummy_list_state(self):
        values = [np.arange(i + 1, dtype=np.float32) for i in range(N)]
        self.run_class_implementation_tests(
            metric=DummySumListStateMetric(device=CPU), state_names={"x"},
            update_kwargs={"x": values}, compute_result=sum(float(v.sum()) for v in values))


def test_dummy_metrics_match_jax():
    pairs = [
        (DummySumMetric(device=CPU), jtest_utils.DummySumMetric(), [(2.0,), (3.5,)]),
        (DummySumListStateMetric(device=CPU), jtest_utils.DummySumListStateMetric(),
         [(np.array([1.0, 2.0], np.float32),), (np.array([3.0], np.float32),)]),
        (DummySumDictStateMetric(device=CPU), jtest_utils.DummySumDictStateMetric(),
         [("a", 1.0), ("a", 2.0), ("b", 5.0)]),
    ]
    for ours, theirs, updates in pairs:
        for args in updates:
            ours.update(*args)
            theirs.update(*args)
        got, want = ours.compute(), theirs.compute()
        if isinstance(want, dict):
            got, want = {k: float(v) for k, v in got.items()}, {k: float(v) for k, v in want.items()}
        assert_result_close(got, want, atol=0, rtol=0)


def test_dummy_dict_state_merges_by_key():
    a = DummySumDictStateMetric(device=CPU).update("x", 1.0)
    b = DummySumDictStateMetric(device=CPU).update("x", 2.0).update("y", 7.0)
    a.merge_state([b])
    assert float(a.x["x"]) == 3.0 and float(a.x["y"]) == 7.0
    assert len(b.x) == 2 and float(b.x["x"]) == 2.0


def test_harness_catches_a_wrong_expected_value():
    """The harness fails, and does not pass quietly, on a wrong value."""
    values = [np.float32(1.0)] * N
    with pytest.raises(AssertionError):
        MetricClassTester().run_class_implementation_tests(
            metric=DummySumMetric(device=CPU), state_names={"sum"},
            update_kwargs={"x": values}, compute_result=np.float32(N + 1))


class _DropsPeers(DummySumMetric):
    """A faulty merge: keeps only the first peer."""

    def merge_state(self, metrics):
        return super().merge_state(list(metrics)[:1])


def test_harness_catches_a_merge_that_drops_a_peer():
    values = [np.float32(1.0)] * N
    with pytest.raises(AssertionError):
        MetricClassTester().run_class_implementation_tests(
            metric=_DropsPeers(device=CPU), state_names={"sum"},
            update_kwargs={"x": values}, compute_result=np.float32(N), test_sync=False)


def test_harness_runs_on_a_copy():
    metric = DummySumMetric(device=CPU)
    before = copy.deepcopy(metric.state_dict())
    MetricClassTester().run_class_implementation_tests(
        metric=metric, state_names={"sum"}, update_kwargs={"x": [np.float32(1.0)] * N},
        compute_result=np.float32(N))
    assert torch.equal(metric.sum, before["sum"])
