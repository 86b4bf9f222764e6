"""Reusable metric-correctness harness (counterpart of
``torcheval_tpu/utils/test_utils/metric_class_tester.py``).

For one metric configuration and ``num_total_updates`` batches it checks:

- the state-name registry;
- that pickling keeps the metric's value and leaves it updatable;
- the ``state_dict`` -> ``load_state_dict`` round trip;
- update/compute against the expected value, ``compute`` idempotent, and
  ``reset`` back to a fresh metric;
- ``merge_state`` over ``num_processes`` simulated replicas (each fed its
  share of the batches): the merged value, the peers left unchanged, the
  merge reproducible from fresh clones, the merged metric still
  updatable; again with the replicas on ``test_devices`` when given;
- a sync of those replicas over a ``LocalReplicaGroup`` (the JAX tester's
  mesh sync): ``toolkit.sync_and_compute`` equals the expected value.
"""

from __future__ import annotations

import copy
import pickle
from typing import Any, Dict, List, Optional, Sequence, Set

import numpy as np
import torch

from torcheval_tpu_torch.distributed import LocalReplicaGroup
from torcheval_tpu_torch.metrics.metric import Metric
from torcheval_tpu_torch.metrics.toolkit import sync_and_compute

NUM_TOTAL_UPDATES = 8
NUM_PROCESSES = 4


def _as_numpy(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def assert_result_close(
    result: Any, expected: Any, atol: float = 1e-5, rtol: float = 1e-5, path: str = ""
) -> None:
    """Recursively compare metric results (tensors, arrays, sequences,
    dicts, scalars), NaN equal to NaN."""
    if expected is None:
        assert result is None, f"{path}: expected None, got {result!r}"
    elif isinstance(expected, dict):
        assert set(result.keys()) == set(expected.keys()), (
            f"{path}: dict keys differ: {set(result)} vs {set(expected)}"
        )
        for k in expected:
            assert_result_close(result[k], expected[k], atol, rtol, f"{path}[{k!r}]")
    elif isinstance(expected, (list, tuple)):
        assert len(result) == len(expected), (
            f"{path}: length {len(result)} != {len(expected)}"
        )
        for i, (r, e) in enumerate(zip(result, expected)):
            assert_result_close(r, e, atol, rtol, f"{path}[{i}]")
    else:
        np.testing.assert_allclose(
            _as_numpy(result),
            _as_numpy(expected),
            atol=atol,
            rtol=rtol,
            equal_nan=True,
            err_msg=f"at {path or 'result'}",
        )


class MetricClassTester:
    """Mixin-style harness; call ``run_class_implementation_tests`` once a
    metric configuration."""

    def run_class_implementation_tests(
        self,
        metric: Metric,
        state_names: Set[str],
        update_kwargs: Dict[str, Sequence[Any]],
        compute_result: Any,
        num_total_updates: int = NUM_TOTAL_UPDATES,
        num_processes: int = NUM_PROCESSES,
        merge_and_compute_result: Optional[Any] = None,
        atol: float = 1e-5,
        rtol: float = 1e-5,
        test_devices: Optional[List[Any]] = None,
        test_sync: bool = True,
    ) -> None:
        assert num_total_updates % num_processes == 0, (
            "num_total_updates must divide evenly among num_processes"
        )
        for name, values in update_kwargs.items():
            assert len(values) == num_total_updates, (
                f"update_kwargs[{name!r}] must have {num_total_updates} entries"
            )
        merge_expected = (
            merge_and_compute_result
            if merge_and_compute_result is not None
            else compute_result
        )
        n, world = num_total_updates, num_processes
        self._test_state_registry(metric, state_names)
        self._test_pickle(metric, update_kwargs, n)
        self._test_state_dict(metric, update_kwargs, n, compute_result, atol, rtol)
        self._test_update_compute(metric, update_kwargs, n, compute_result, atol, rtol)
        for devices in [None] + ([test_devices] if test_devices else []):
            self._test_merge_state(
                metric, update_kwargs, n, world, merge_expected, atol, rtol, devices
            )
        if test_sync:
            self._test_sync(metric, update_kwargs, n, world, merge_expected, atol, rtol)

    # ---------------------------------------------------------------- pieces

    @staticmethod
    def _kwargs_for(update_kwargs: Dict[str, Sequence[Any]], i: int) -> Dict[str, Any]:
        return {name: values[i] for name, values in update_kwargs.items()}

    def _apply_updates(self, metric: Metric, update_kwargs, indices) -> Metric:
        for i in indices:
            metric.update(**self._kwargs_for(update_kwargs, i))
        return metric

    def _test_state_registry(self, metric: Metric, state_names: Set[str]) -> None:
        assert set(metric._state_name_to_default) == state_names, (
            f"state registry {set(metric._state_name_to_default)} != {state_names}"
        )

    def _test_pickle(self, metric, update_kwargs, n) -> None:
        m = copy.deepcopy(metric)
        self._apply_updates(m, update_kwargs, range(n // 2))
        m2 = pickle.loads(pickle.dumps(m))
        assert_result_close(m2.compute(), m.compute())
        # an unpickled metric stays updatable
        self._apply_updates(m2, update_kwargs, range(n // 2, n))

    def _test_state_dict(self, metric, update_kwargs, n, compute_result, atol, rtol) -> None:
        m = copy.deepcopy(metric)
        self._apply_updates(m, update_kwargs, range(n // 2))
        fresh = copy.deepcopy(metric)
        fresh.load_state_dict(m.state_dict())
        self._apply_updates(fresh, update_kwargs, range(n // 2, n))
        assert_result_close(fresh.compute(), compute_result, atol, rtol)

    def _test_update_compute(self, metric, update_kwargs, n, compute_result, atol, rtol) -> None:
        m = copy.deepcopy(metric)
        self._apply_updates(m, update_kwargs, range(n))
        assert_result_close(m.compute(), compute_result, atol, rtol)
        # compute is idempotent and leaves the state alone
        assert_result_close(m.compute(), compute_result, atol, rtol)
        # reset returns to a fresh metric
        m.reset()
        m2 = copy.deepcopy(metric)
        self._apply_updates(m, update_kwargs, range(n))
        self._apply_updates(m2, update_kwargs, range(n))
        assert_result_close(m.compute(), m2.compute(), atol, rtol)

    def _rank_metrics(self, metric, update_kwargs, n, world, devices=None) -> List[Metric]:
        per_rank = n // world
        metrics = []
        for rank in range(world):
            m = copy.deepcopy(metric)
            if devices is not None:
                m.to(devices[rank % len(devices)])
            self._apply_updates(m, update_kwargs, range(rank * per_rank, (rank + 1) * per_rank))
            metrics.append(m)
        return metrics

    def _test_merge_state(
        self, metric, update_kwargs, n, world, merge_expected, atol, rtol, devices
    ) -> None:
        ranks = self._rank_metrics(metric, update_kwargs, n, world, devices)
        peers_before = [r.compute() for r in ranks[1:]]
        target = copy.deepcopy(ranks[0])
        target.merge_state(ranks[1:])
        assert_result_close(target.compute(), merge_expected, atol, rtol)
        # the peers are left as they were
        for before, r in zip(peers_before, ranks[1:]):
            assert_result_close(r.compute(), before, atol, rtol)
        # the merge is reproducible from fresh clones
        target2 = copy.deepcopy(ranks[0])
        target2.merge_state(ranks[1:])
        assert_result_close(target2.compute(), merge_expected, atol, rtol)
        # the merged metric stays updatable
        target.update(**self._kwargs_for(update_kwargs, 0))

    def _test_sync(self, metric, update_kwargs, n, world, merge_expected, atol, rtol) -> None:
        group = LocalReplicaGroup([metric.device] * world)
        ranks = self._rank_metrics(metric, update_kwargs, n, world)
        assert_result_close(sync_and_compute(ranks, group), merge_expected, atol, rtol)
