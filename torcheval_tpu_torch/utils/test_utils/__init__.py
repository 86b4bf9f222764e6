"""Test helpers: the dummy metrics, the per-class contract harness, the
rank-per-thread world, the fault-injection harnesses, the seeded
overload schedules and the deterministic-schedule race harness."""

from torcheval_tpu_torch.utils.test_utils.dummy_metric import (
    DummySumDictStateMetric,
    DummySumListStateMetric,
    DummySumMetric,
)
from torcheval_tpu_torch.utils.test_utils.fault_injection import (
    FaultInjectionGroup,
    FaultSpec,
    InjectedCrash,
    SnapshotCrashPlan,
    corrupt_manifest_digest,
    corrupt_shard,
    truncate_shard,
)
from torcheval_tpu_torch.utils.test_utils.metric_class_tester import (
    MetricClassTester,
    assert_result_close,
)
from torcheval_tpu_torch.utils.test_utils.overload import (
    OverloadBatch,
    OverloadPhase,
    OverloadSchedule,
)
from torcheval_tpu_torch.utils.test_utils.schedule import (
    DeadlockError,
    DeterministicScheduler,
    ScheduleResult,
)
from torcheval_tpu_torch.utils.test_utils.thread_world import (
    ThreadRankGroup,
    ThreadWorld,
)

__all__ = [
    "DeadlockError",
    "DeterministicScheduler",
    "DummySumDictStateMetric",
    "DummySumListStateMetric",
    "DummySumMetric",
    "FaultInjectionGroup",
    "FaultSpec",
    "InjectedCrash",
    "MetricClassTester",
    "OverloadBatch",
    "OverloadPhase",
    "OverloadSchedule",
    "ScheduleResult",
    "SnapshotCrashPlan",
    "ThreadRankGroup",
    "ThreadWorld",
    "assert_result_close",
    "corrupt_manifest_digest",
    "corrupt_shard",
    "truncate_shard",
]
