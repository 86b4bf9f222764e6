"""Test helpers: the dummy metrics and the per-class contract harness."""

from torcheval_tpu_torch.utils.test_utils.dummy_metric import (
    DummySumDictStateMetric,
    DummySumListStateMetric,
    DummySumMetric,
)
from torcheval_tpu_torch.utils.test_utils.metric_class_tester import (
    MetricClassTester,
    assert_result_close,
)

__all__ = [
    "DummySumDictStateMetric",
    "DummySumListStateMetric",
    "DummySumMetric",
    "MetricClassTester",
    "assert_result_close",
]
