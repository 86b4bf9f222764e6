"""The torch half of ``torcheval_tpu_torch.analysis``: the program
verifier on fake tensors under the dispatch recorder, and the lockstep
checker on loop-back rank views. The counterparts of
``tests/analysis/test_program_verifier.py`` and
``tests/analysis/test_lockstep.py``: every rule fires on a seeded program
and passes clean on a sound one, nothing executes; then the family sweep
on CPU metrics, call-layer donation on shared storage, and the eager sync
plan held to the JAX package's for the same collection."""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torcheval_tpu.metrics as JM
from torcheval_tpu.analysis import eager_sync_plan as jax_eager_sync_plan

import chip_smoke
import torcheval_tpu_torch.metrics as TM
from torcheval_tpu_torch import config
from torcheval_tpu_torch.analysis import (
    PlanRecordingGroup,
    assert_donated_update_in_place,
    assert_update_transfer_free,
    check_donation_aliasing,
    check_eager_lockstep,
    check_program_lockstep,
    collective_plan,
    compare_collective_sequences,
    eager_sync_plan,
    last_report,
    verify_metric_compute,
    verify_metric_merge,
    verify_metric_update,
    verify_program,
    verify_rank_lockstep,
)
from torcheval_tpu_torch.metrics.metric import MergeKind, Metric, UpdatePlan
from torcheval_tpu_torch.metrics.sharded import sync_states_in_jit
from torcheval_tpu_torch.parallel import _axis, moe_apply, ring_attention
from torcheval_tpu_torch.parallel import backward as parallel_backward
from torcheval_tpu_torch.utils.convert import narrow_64
from torcheval_tpu_torch.utils.test_utils import ThreadWorld

CPU = "cpu"
RNG = np.random.default_rng(11)
X8 = torch.zeros(8)
K1_OP = "torcheval_tpu_torch.fused_auc_hist_.default"


def _rules(report):
    return sorted({f.rule for f in report.findings if not f.suppressed})


@pytest.fixture(scope="module")
def world1():
    """A world-1 gloo default group over an in-process store."""
    created = not dist.is_initialized()
    if created:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    yield
    if created:
        dist.destroy_process_group()


# ------------------------------------------------------------ host escapes


def test_clean_program_passes():
    report = verify_program(
        lambda x: torch.tanh(x).sum(), X8, expect_collectives=0, expect_hlo_collectives=0
    )
    assert report.ok, report.format_text()
    assert report.collectives == () and report.hlo_collectives == ()
    assert report.host_escapes == ()
    assert report.ops and all(not o.startswith("prim.") for o in report.ops)


def test_item_is_a_host_escape():
    def escapes(x):
        return x * x.sum().item()

    report = verify_program(escapes, X8, compile_hlo=False)
    assert "host-callback" in _rules(report)
    assert report.host_escapes == ("aten._local_scalar_dense.default",)
    # provenance points at the program's own line, not torch internals
    finding = [f for f in report.findings if f.rule == "host-callback"][0]
    assert "test_torch_port_analysis_program.py" in finding.message


def test_copy_from_an_accelerator_is_a_host_escape():
    def escapes(x):
        # a fake tensor on the card (this CPU build makes them by factory)
        on_card = torch.ones(8, device="cuda")
        return on_card.cpu() * x

    report = verify_program(escapes, X8, compile_hlo=False)
    assert "host-callback" in _rules(report)
    assert report.host_escapes == ("aten._to_copy.default",)


@pytest.mark.parametrize(
    "op",
    [
        lambda x: torch.nonzero(x),
        lambda x: torch.bincount(x.to(torch.int32)),
        lambda x: torch.unique(x),
        lambda x: x[x > 0],
    ],
    ids=["nonzero", "bincount", "unique", "masked_select"],
)
def test_data_dependent_shape_is_a_host_escape(op):
    report = verify_program(op, X8, compile_hlo=False)
    assert "host-callback" in _rules(report)
    assert report.host_escapes


def test_numpy_of_a_tensor_is_a_host_escape():
    report = verify_program(lambda x: torch.from_numpy(x.numpy() * 2), X8, compile_hlo=False)
    assert report.host_escapes == ("Tensor.numpy",)


def test_allow_host_escapes_downgrades_to_census_only():
    report = verify_program(
        lambda x: x * float(x.sum()), X8, allow_host_escapes=True, compile_hlo=False
    )
    assert report.ok
    assert report.host_escapes  # still in the census, just not a finding


# ------------------------------------------------------- collective census


def _two_reductions(x):
    s, m = x.sum(), x.max()
    dist.all_reduce(s)
    dist.all_reduce(m, op=dist.ReduceOp.MAX)
    return s + m


def test_collective_census_count_and_sequence(world1):
    report = verify_program(_two_reductions, X8, expect_collectives=0, compile_hlo=False)
    assert _rules(report) == ["collective-census"]
    seq = list(verify_program(_two_reductions, X8, compile_hlo=False).collectives)
    assert seq == ["c10d.allreduce_.default"] * 2
    assert verify_program(_two_reductions, X8, expect_collectives=seq).ok

    def gather_then_reduce(x):
        out = torch.empty(dist.get_world_size() * 8)
        dist.all_gather_into_tensor(out, x)
        dist.all_reduce(x)
        return out

    order = list(verify_program(gather_then_reduce, X8).collectives)
    assert len(order) == 2
    reordered = verify_program(
        gather_then_reduce, X8, expect_collectives=list(reversed(order))
    )
    assert "collective-census" in _rules(reordered)


def test_c10d_census_view(world1):
    ok = verify_program(_two_reductions, X8, expect_hlo_collectives=["c10d.allreduce_.default"] * 2)
    assert ok.ok, ok.format_text()
    bad = verify_program(_two_reductions, X8, expect_hlo_collectives=["c10d.allgather_.default"])
    assert "collective-census" in _rules(bad)


def test_parallel_and_group_collectives_join_the_census():
    group = PlanRecordingGroup(2, 0)

    def step(x):
        y = _axis.psum(x, group)
        group.allgather_object({"n": 1})
        return y

    report = verify_program(step, X8)
    assert report.collectives == ("parallel.psum", "ProcessGroup.allgather_object")
    assert report.hlo_collectives == ()


def test_group_gathers_are_heard_once_at_their_caller():
    from torcheval_tpu_torch.analysis.program import _Trace
    from torcheval_tpu_torch.distributed import ProcessGroup

    class Echo(ProcessGroup):  # defined after every trace above
        world_size = 1
        rank = 0

        def allgather_object(self, obj):
            return [obj]

    class Wrapper(ProcessGroup):
        world_size = 1
        rank = 0

        def __init__(self, inner):
            self.inner = inner

        def allgather_object(self, obj):
            return self.inner.allgather_object(obj)

    group = Wrapper(Echo())

    def step(x):
        group.allgather_object_with_ranks(1)  # -> Wrapper -> Echo: one gather
        return x + 1

    assert verify_program(step, X8).collectives == ("ProcessGroup.allgather_object_with_ranks",)
    with _Trace(None) as rec:
        step(X8)
    ((name, where),) = rec.collectives
    assert name == "ProcessGroup.allgather_object_with_ranks"
    assert "test_torch_port_analysis_program.py" in where and "(step)" in where, where
    group.allgather_object(2)  # no trace: nothing listens
    assert len(rec.collectives) == 1


def test_compare_collective_sequences_budget(world1):
    def base(x):
        dist.all_reduce(x)
        return x

    def synced(x):
        dist.all_reduce(x)
        out = torch.empty(dist.get_world_size() * 8)
        dist.all_gather_into_tensor(out, x)
        return x, out

    over = compare_collective_sequences(base, (X8,), synced, (X8,))
    assert "added-collectives" in _rules(over)
    added = [c for c in over.collectives if "allreduce" not in c]
    declared = compare_collective_sequences(base, (X8,), synced, (X8,), allow_added=added)
    assert declared.ok, declared.format_text()
    assert compare_collective_sequences(base, (X8,), base, (X8,)).ok


# ------------------------------------------------------------ dtype safety


def test_dtype_64bit_flows_are_flagged():
    report = verify_program(lambda x: x + 1, torch.zeros(4, dtype=torch.float64))
    assert "dtype-64bit" in _rules(report)


def test_int64_state_and_output_are_flagged_but_intermediates_are_not():
    state = torch.zeros(4, dtype=torch.int64)
    report = verify_program(lambda s: s + 1, state, state_argnums=(0,))
    assert "dtype-64bit" in _rules(report)
    # argmax makes an int64 index; cast to int32 it leaves no trace
    clean = verify_program(
        lambda x: torch.argmax(x.reshape(2, 4), dim=-1).to(torch.int32), X8
    )
    assert clean.ok, clean.format_text()


def test_dtype_narrowing_cast_is_flagged():
    report = verify_program(
        lambda x: x.to(torch.float32), torch.zeros(4, dtype=torch.float64), compile_hlo=False
    )
    assert "dtype-narrowing" in _rules(report)
    state = torch.zeros(4, dtype=torch.int64)
    report = verify_program(lambda s: s.to(torch.int32), state, state_argnums=(0,))
    assert "dtype-narrowing" in _rules(report)


def test_narrowing_through_narrow_64_is_not_flagged():
    report = verify_program(
        lambda x: narrow_64(x) + 1, torch.zeros(4, dtype=torch.float64), compile_hlo=False
    )
    assert "dtype-narrowing" not in _rules(report)


def test_x32_programs_are_dtype_clean():
    report = verify_program(lambda x: x.to(torch.int32) + 1, X8)
    assert report.ok, report.format_text()


# ------------------------------------------------------ donation soundness


def test_donated_params_must_be_aliased():
    def f(dead, x):
        return x * 2.0

    report = verify_program(f, torch.zeros(7), torch.zeros(4), donate_argnums=(0,))
    assert "donated-not-aliased" in _rules(report)
    assert report.donated_params == (0,)
    assert 0 not in report.aliased_params


def test_sound_donation_passes():
    report = verify_program(lambda s, d: s.add_(d), torch.zeros(8), torch.zeros(8), donate_argnums=(0,))
    assert report.ok, report.format_text()
    assert set(report.donated_params) <= set(report.aliased_params)


def test_donated_pytree_indices_flatten_correctly():
    def f(states, d):
        return tuple(s + d for s in states)

    report = verify_program(
        f, (torch.zeros(8), torch.zeros(8)), torch.zeros(8), donate_argnums=(0,)
    )
    assert report.ok, report.format_text()
    assert report.donated_params == (0, 1)


def test_donated_scalar_is_a_warning():
    report = verify_program(lambda s, x: x.sum(0), torch.zeros(()), torch.zeros(4, 3), donate_argnums=(0,))
    assert report.ok
    assert [f.severity for f in report.findings if f.rule == "donated-not-aliased"] == ["warning"]


def test_donated_twice_is_flagged():
    x = torch.ones(8)
    assert "donated-twice" in _rules(check_donation_aliasing(((x, x),), (0,)))


def test_views_of_one_storage_are_one_buffer():
    # shared storage, different tensor objects: still one buffer
    x = torch.ones(8)
    assert "donated-twice" in _rules(check_donation_aliasing(((x[:4], x[4:]),), (0,)))
    assert "donated-also-read" in _rules(check_donation_aliasing(((x,), x.view(2, 4)), (0,)))


def test_donated_buffer_also_read_is_flagged():
    x = torch.ones(8)
    assert "donated-also-read" in _rules(check_donation_aliasing(((x,), x), (0,)))


def test_distinct_buffers_pass_call_layer_check():
    report = check_donation_aliasing(((torch.ones(8),), torch.zeros(8)), (0,))
    assert report.ok, report.format_text()


# ----------------------------------------------------------- report plumbing


def test_last_report_tracks_verifier_runs():
    report = verify_program(lambda x: x + 1, X8, name="plumbing-probe", compile_hlo=False)
    assert last_report() is report
    payload = report.as_dict()
    assert payload["name"] == "plumbing-probe"
    assert payload["tool"] == "program"
    assert payload["schema_version"] == 1


# ------------------------------------------------------ bucketed variants


def test_bucketed_masked_program_is_verified_too():
    x2 = torch.from_numpy(RNG.random((48, 5)).astype(np.float32))  # non-pow2
    t1 = torch.from_numpy(RNG.integers(0, 5, 48).astype(np.int32))
    metric = TM.MulticlassAccuracy(device=CPU)
    assert metric._update_plan(x2, t1).masked_kernel is not None
    report = verify_metric_update(metric, x2, t1)
    assert report.ok, report.format_text()
    assert report.checked >= 2


class _Seeded(Metric):
    """A plan whose masked twin reads the valid extents back."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self._add_state("total", torch.zeros(()))

    def _update_plan(self, x):
        return UpdatePlan(
            kernel=lambda x: (x.sum(),),
            state_names=("total",),
            dynamic=(x,),
            masked_kernel=lambda x, valid: (x[: int(valid[0])].sum(),),
            batch_axes=(("n",),),
        )

    def update(self, x):
        return self._apply_update_plan(self._update_plan(self._input(x)))

    def compute(self):
        return self.total


def test_seeded_violation_in_masked_kernel_is_caught():
    x = torch.rand(12)
    report = verify_metric_update(_Seeded(device=CPU), x)
    bad = [f for f in report.findings if f.rule == "host-callback"]
    assert bad, report.format_text()
    assert all("[bucketed]" in f.path for f in bad)


# ------------------------------------------------------------ K1, the op


def test_k1_is_one_op_on_fake_cuda_tensors():
    from torcheval_tpu_torch.ops.fused_auc import histogram_accumulate_kernel

    def update(n):
        # fake tensors on the card, made by factory (nothing is allocated)
        hist = torch.zeros((1, 2, 64), device="cuda")
        s, y = torch.rand(n.shape[0], device="cuda"), torch.rand(n.shape[0], device="cuda")
        (out,) = histogram_accumulate_kernel((hist,), s, y, None, 64, (0.0, 1.0))
        return out

    report = verify_program(update, torch.zeros(100))
    assert report.count(K1_OP) == 1
    assert report.ok, report.format_text()


def test_k1_plain_version_traces_on_the_cpu():
    metric = TM.StreamingBinaryAUROC(num_bins=64, device=CPU)
    report = verify_metric_update(metric, torch.rand(100), torch.randint(0, 2, (100,)))
    assert report.ok and report.count(K1_OP) == 0


def test_k1_op_has_no_cpu_kernel():
    from torcheval_tpu_torch.ops.fused_auc import K1_OP as op

    with pytest.raises(NotImplementedError):
        op(torch.zeros(1, 2, 4), torch.zeros(1, 3), torch.zeros(1, 3), None, 4, [0.0, 1.0])


# -------------------------------------------------------------- runtime pins


class _ItemMean(TM.Mean):
    def _update_plan(self, input, *, weight=1.0):
        x = self._input_float(input)
        return ((lambda x: (x.sum() * (x.sum().item() > 0), torch.ones(()))),
                ("weighted_sum", "weights"), (x,))


def test_runtime_transfer_pin_uses_the_recorder_on_the_cpu():
    assert_update_transfer_free(TM.Mean(device=CPU), (torch.rand(16),), warm=2)
    with pytest.raises(RuntimeError, match="_local_scalar_dense"):
        assert_update_transfer_free(_ItemMean(device=CPU), (torch.rand(16),), warm=0)


def test_runtime_in_place_pin():
    metric = TM.MulticlassAccuracy(device=CPU)
    x2 = torch.rand(16, 5)
    t1 = torch.randint(0, 5, (16,), dtype=torch.int32)
    assert_donated_update_in_place(metric, (x2, t1), "num_correct", warm=1, steps=2)


# --------------------------------------------------------------- families

FAMILIES = chip_smoke._analysis_families(CPU, 23)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_every_fused_family_verifies_on_cpu_metrics(name):
    from torcheval_tpu_torch.obs import quality

    fam = FAMILIES[name]
    metric = fam.make()
    try:
        update = verify_metric_update(metric, *fam.args, **fam.kwargs)
        assert update is not None and update.ok, update.format_text()
        assert update.collectives == () and update.host_escapes == ()
        assert update.donated_params and set(update.donated_params) <= set(update.aliased_params)
        for report in (verify_metric_compute(metric), verify_metric_merge(metric)):
            errors = [f for f in report.active if f.severity == "error"]
            assert not errors, report.format_text()
            assert report.collectives == ()
    finally:
        for watch in quality.active_watches():
            watch.close()


# ------------------------------------------------------- rank-divergent plans


def _build_leader_extra(rank):
    group = PlanRecordingGroup(4, rank)

    def step(x):
        total = _axis.psum(x.sum(), group)
        if rank == 0:  # deliberate: rank-dependent program structure
            total = total + _axis.psum(x.max(), group)
        return total

    return step


def test_rank_divergent_program_is_flagged():
    report = verify_rank_lockstep(_build_leader_extra, range(4), X8, name="leader-extra")
    assert not report.ok
    findings = [f for f in report.findings if f.rule == "rank-divergent-collective"]
    assert len(findings) == 3  # ranks 1..3 each diverge from rank 0
    assert "deadlock" in findings[0].message
    assert "psum" in findings[0].message


def test_rank_uniform_spmd_program_passes():
    def build(rank):
        group = PlanRecordingGroup(8, rank)
        return lambda x: _axis.psum(x.sum(), group)

    report = verify_rank_lockstep(build, range(8), X8)
    assert report.ok, report.format_text()
    assert report.checked == 8


def test_reordered_collectives_are_divergence():
    def build(rank):
        group = PlanRecordingGroup(2, rank)

        def step(x):
            if rank % 2 == 0:
                return _axis.psum(x, group) + _axis.all_to_all(x, group)
            return _axis.all_to_all(x, group) + _axis.psum(x, group)

        return step

    report = verify_rank_lockstep(build, range(2), X8)
    assert "rank-divergent-collective" in _rules(report)


# --------------------------------------------- data-dependent plans (1 prog)

_GROUP = PlanRecordingGroup(2, 0)


def test_branch_dependent_collective_is_flagged():
    def step(x, flag):
        if flag[0] > 0:
            return _axis.psum(x, _GROUP)
        return x * 2.0

    report = check_program_lockstep(step, torch.ones(8), torch.ones(1))
    assert _rules(report) == ["branch-dependent-collective"]
    assert "deadlock" in report.findings[0].message


def test_symmetric_branches_pass():
    def step(x, flag):
        if flag[0] > 0:
            return _axis.psum(x.sum(), _GROUP)
        return _axis.psum(x.max(), _GROUP) * 0.5

    report = check_program_lockstep(step, torch.ones(8), torch.ones(1))
    assert report.ok, report.format_text()


def test_collective_in_a_data_dependent_loop_is_a_warning():
    def step(x):
        acc = torch.zeros(())
        for _ in range(int(x.abs().sum()) % 3 + 1):
            acc = acc + _axis.psum(x.sum(), _GROUP)
        return acc

    report = check_program_lockstep(step, torch.ones(8), variants=6)
    assert report.ok  # warning severity: rank-uniform trip counts are fine
    assert _rules(report) == ["collective-in-loop"]
    assert all(f.severity == "warning" for f in report.findings)


# ------------------------------------------- existing library sync programs


def test_library_sync_programs_pass(world1):
    def sync(x):
        return sync_states_in_jit(
            {"a": x.sum(), "b": x.max(), "c": x.min(), "buf": x},
            None,
            {"a": MergeKind.SUM, "b": MergeKind.MAX, "c": MergeKind.MIN, "buf": MergeKind.EXTEND},
        )

    x = torch.rand(8)
    report = check_program_lockstep(sync, x)
    assert report.ok, report.format_text()
    plan = collective_plan(sync, x)
    assert plan and all(op.name.startswith("c10d.") for op in plan)
    assert verify_rank_lockstep(lambda r: sync, range(4), x).ok


def test_parallel_plans_are_lockstep_and_match_the_census():
    # the counterpart of the composed-axes sync: ring attention and MoE,
    # forward and parallel.backward, recorded per rank on loop-back views
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 32, 2, 8, generator=gen) for _ in range(3))

    def ring_for(group, rank):
        def program(q, k, v):
            mine = [t[:, rank * 8:(rank + 1) * 8].clone().requires_grad_(True) for t in (q, k, v)]
            parallel_backward((ring_attention(*mine, group=group) ** 2).sum())
        return program

    x = torch.randn(4 * 16, 8, generator=gen)
    wg, w1, w2 = (torch.randn(8, 4, generator=gen), torch.randn(4, 8, 16, generator=gen),
                  torch.randn(4, 16, 8, generator=gen))

    def moe_for(group, rank):
        def program(x, wg, w1, w2):
            mine = [t.clone().requires_grad_(True)
                    for t in (x[rank * 16:(rank + 1) * 16], wg, w1[rank], w2[rank])]
            parallel_backward((moe_apply(*mine, group=group, capacity=5) ** 2).sum())
        return program

    for make, args in ((ring_for, (q, k, v)), (moe_for, (x, wg, w1, w2))):
        report = verify_rank_lockstep(
            lambda r: make(PlanRecordingGroup(4, r), r), range(4), *args, check_structure=False
        )
        assert report.ok, report.format_text()
        plan = collective_plan(make(PlanRecordingGroup(4, 0), 0), *args)
        counts = {}
        for op in plan:
            counts[op.name.split(".", 1)[1]] = counts.get(op.name.split(".", 1)[1], 0) + 1

        def rank(g, make=make, args=args):
            with _axis.census() as calls:
                make(g, g.rank)(*args)
            return dict(calls)

        assert all(c == counts for c in ThreadWorld(4).run(rank))


# ------------------------------------------------------- eager call plans


def _collection():
    coll = {
        "acc": TM.MulticlassAccuracy(device=CPU),
        "mse": TM.MeanSquaredError(device=CPU),
        "auroc": TM.BinaryAUROC(device=CPU),
    }
    x2 = torch.from_numpy(RNG.random((16, 5)).astype(np.float32))
    t1 = torch.from_numpy(RNG.integers(0, 5, 16).astype(np.int32))
    xb = torch.from_numpy(RNG.random(16).astype(np.float32))
    tb = torch.from_numpy(RNG.integers(0, 2, 16).astype(np.float32))
    coll["acc"].update(x2, t1)
    coll["mse"].update(xb, tb)
    coll["auroc"].update(xb, tb)
    return coll


def test_identical_collections_have_lockstep_plans():
    coll = _collection()
    plans = {rank: eager_sync_plan(coll, world_size=4, rank=rank) for rank in range(4)}
    report = check_eager_lockstep(plans)
    assert report.ok, report.format_text()
    assert report.checked == 4
    assert len(plans[0]) == 2
    assert plans[0][0].startswith("allgather_object[")
    assert plans[0][1] == "allgather_array"


def test_eager_plan_equals_the_jax_packages():
    rng = np.random.default_rng(3)
    x2 = rng.random((16, 5)).astype(np.float32)
    t1 = rng.integers(0, 5, 16).astype(np.int32)
    xb = rng.random(16).astype(np.float32)
    tb = rng.integers(0, 2, 16).astype(np.float32)
    port = {"acc": TM.MulticlassAccuracy(device=CPU), "mse": TM.MeanSquaredError(device=CPU),
            "auroc": TM.BinaryAUROC(device=CPU), "hist": TM.StreamingBinaryAUROC(device=CPU)}
    ref = {"acc": JM.MulticlassAccuracy(), "mse": JM.MeanSquaredError(),
           "auroc": JM.BinaryAUROC(), "hist": JM.StreamingBinaryAUROC()}
    port["acc"].update(torch.from_numpy(x2), torch.from_numpy(t1))
    ref["acc"].update(x2, t1)
    for name in ("mse", "auroc", "hist"):
        port[name].update(torch.from_numpy(xb), torch.from_numpy(tb))
        ref[name].update(xb, tb)
    for rank in range(2):
        assert eager_sync_plan(port, world_size=2, rank=rank) == jax_eager_sync_plan(
            ref, world_size=2, rank=rank
        )


def test_mismatched_collections_diverge():
    coll = _collection()
    partial_coll = {k: v for k, v in coll.items() if k != "auroc"}
    report = check_eager_lockstep(
        {
            0: eager_sync_plan(coll, world_size=2, rank=0),
            1: eager_sync_plan(partial_coll, world_size=2, rank=1),
        }
    )
    assert _rules(report) == ["eager-plan-divergence"]
    assert "deadlock" in report.findings[0].message


def test_fill_level_does_not_fake_divergence():
    a = _collection()
    b = _collection()
    b["auroc"].update(torch.rand(64), torch.randint(0, 2, (64,)).float())
    report = check_eager_lockstep(
        {0: eager_sync_plan(a, world_size=2, rank=0), 1: eager_sync_plan(b, world_size=2, rank=1)}
    )
    assert report.ok, report.format_text()


def test_hand_recorded_plans_ignore_local_payload_sizes():
    g0 = PlanRecordingGroup(world_size=2, rank=0)
    g1 = PlanRecordingGroup(world_size=2, rank=1)
    for group, n in ((g0, 10), (g1, 20)):
        group.allgather_object({"m": ["s"]})
        group.allgather_array(np.zeros(n, np.float32))
    assert g0.calls != g1.calls
    assert check_eager_lockstep({0: g0.calls, 1: g1.calls}).ok
    g1.allgather_object({"m": ["s"]})
    assert _rules(check_eager_lockstep({0: g0.calls, 1: g1.calls})) == ["eager-plan-divergence"]


def test_subgroup_scoped_plans_are_lockstep():
    coll = _collection()
    whole = eager_sync_plan(coll, world_size=4, rank=0)
    sub = eager_sync_plan(coll, world_size=2, rank=1)
    assert whole == sub
    assert check_eager_lockstep({0: whole, 2: sub, 3: sub}).ok


def test_eager_plan_does_not_consume_the_metrics():
    coll = _collection()
    before = {n: m.state_dict() for n, m in coll.items()}
    value = float(coll["auroc"].compute())
    eager_sync_plan(coll, world_size=2)
    assert float(coll["auroc"].compute()) == value
    for name, metric in coll.items():
        after = metric.state_dict()
        assert before[name].keys() == after.keys()
        for key, v in before[name].items():
            got = after[key]
            if isinstance(v, torch.Tensor):
                assert torch.equal(v, got)
            elif isinstance(v, list):
                assert len(v) == len(got) and all(torch.equal(a, b) for a, b in zip(v, got))
            else:
                assert v == got


def test_all_empty_collection_plans_stay_uniform():
    empty = {"auroc": TM.BinaryAUROC(device=CPU)}
    plans = {rank: eager_sync_plan(empty, world_size=2, rank=rank) for rank in range(2)}
    assert plans[0] == plans[1]
    assert check_eager_lockstep(plans).ok


def test_plans_under_donation_match_without():
    coll = _collection()
    with config.update_donation(True):
        donated = eager_sync_plan(coll, world_size=2, rank=0)
    assert donated == eager_sync_plan(coll, world_size=2, rank=0)
