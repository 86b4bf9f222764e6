"""Test helpers: the dummy metrics, the per-class contract harness, the
rank-per-thread world, the fault-injection harnesses (collective chaos,
inter-region link chaos, snapshot crashes, scripted rank kills), the
seeded overload schedules and the deterministic-schedule race harness."""

from torcheval_tpu_torch.utils.test_utils.dummy_metric import (
    DummySumDictStateMetric,
    DummySumListStateMetric,
    DummySumMetric,
)
from torcheval_tpu_torch.utils.test_utils.fault_injection import (
    ChaosLinkTransport,
    FaultInjectionGroup,
    FaultSpec,
    InjectedCrash,
    LinkFaultSpec,
    SnapshotCrashPlan,
    corrupt_manifest_digest,
    corrupt_shard,
    truncate_shard,
)
from torcheval_tpu_torch.utils.test_utils.kill_schedule import (
    KILL_POINTS,
    KillGroup,
    KillSchedule,
    KillSpec,
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
    "ChaosLinkTransport",
    "DeadlockError",
    "DeterministicScheduler",
    "DummySumDictStateMetric",
    "DummySumListStateMetric",
    "DummySumMetric",
    "FaultInjectionGroup",
    "FaultSpec",
    "InjectedCrash",
    "KILL_POINTS",
    "KillGroup",
    "KillSchedule",
    "KillSpec",
    "LinkFaultSpec",
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
