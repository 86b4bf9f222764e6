"""torcheval_tpu_torch's update runner, panels and donation against the
JAX package's.

- ``_fuse``: the arity check's message; the eager accumulate and
  transform semantics against the JAX ``fused_accumulate`` /
  ``fused_transform`` / ``fused_accumulate_group`` on the same numpy
  inputs; in place under donation wherever the result keeps the state's
  dtype and shape, a new tensor otherwise; ``graph=True`` refuses CPU
  states instead of running them some other way;
- ``toolkit.update_collection``: the JAX package's two groups under
  bucketing (bucketed against plain), one pad per shared argument, one
  conversion per input, inputs never written, no metric changed by a
  rejected batch, the same values as the JAX panel;
- donation: the per-device default, the compute shield (a ``Sum`` value
  unchanged by a later in-place update), ``reset`` in place;
- the ``bucket`` phase of ``chip_smoke.py`` is in
  ``test_torch_port_slice.py``.

Tolerances: counters bitwise; float sums within rtol 1e-6.
"""

from __future__ import annotations

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torcheval_tpu.config as jconfig
import torcheval_tpu.metrics as JM
import torcheval_tpu_torch.config as tconfig
import torcheval_tpu_torch.metrics as TM
from torcheval_tpu.metrics import _fuse as jfuse
from torcheval_tpu.metrics import toolkit as jtoolkit
from torcheval_tpu_torch.metrics import _bucket as tbucket
from torcheval_tpu_torch.metrics import _fuse as tfuse
from torcheval_tpu_torch.metrics import toolkit as ttoolkit
from torcheval_tpu_torch.metrics.metric import Metric, MergeKind, UpdatePlan
from torcheval_tpu_torch.ops import _kernels as tkernels
from torcheval_tpu_torch.utils import convert as tconvert
from torcheval_tpu_torch.utils.convert import numpy_state_dict

CPU = "cpu"
RTOL = 1e-6


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------------ _fuse


def _two(x):
    return jnp.sum(x), jnp.max(x)


def _one(x):
    return x * 2


def _t_two(x):
    return torch.sum(x), torch.amax(x)


def _t_one(x):
    return x * 2


def test_arity_error_message_matches_jax():
    with pytest.raises(ValueError) as terr:
        tfuse.fused_accumulate(_one, (torch.zeros(3), torch.zeros(())), (torch.ones(3),))
    with pytest.raises(ValueError) as jerr:
        jfuse.fused_accumulate(_one, (jnp.zeros(3), jnp.zeros(())), (jnp.ones(3),))
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError) as terr:
        tfuse._check_arity(_one, (1, 2, 3), (0,))
    with pytest.raises(ValueError) as jerr:
        jfuse._check_arity(_one, (1, 2, 3), (0,))
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("donate", [False, True])
def test_eager_accumulate_matches_jax(donate):
    x = np.random.default_rng(0).random(6).astype(np.float32)
    s0, s1 = torch.full((), 1.5), torch.full((), -2.0)
    want = jfuse.fused_accumulate(_two, (jnp.float32(1.5), jnp.float32(-2.0)), (jnp.asarray(x),))
    got = tfuse.fused_accumulate(_t_two, (s0, s1), (torch.from_numpy(x),), donate=donate)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=RTOL)
    # in place exactly when donating
    assert (got[0] is s0) == donate and (got[1] is s1) == donate
    if not donate:
        assert float(s0) == 1.5 and float(s1) == -2.0


def test_donated_accumulate_goes_out_of_place_when_the_sum_grows():
    """A scalar state meeting per-output deltas becomes a new (C,) tensor,
    as an XLA buffer of another shape cannot alias; an int32 state meeting
    float deltas is promoted the same way."""
    s = torch.zeros(())
    (new,) = tfuse.fused_accumulate(lambda x: torch.sum(x, dim=0), (s,), (torch.ones(4, 3),),
                                    donate=True)
    assert new is not s and new.shape == (3,) and float(s) == 0.0
    i = torch.zeros(2, dtype=torch.int32)
    (new,) = tfuse.fused_accumulate(lambda x: x, (i,), (torch.full((2,), 0.5),), donate=True)
    assert new is not i and new.dtype == torch.float32


def _j_shift(states, x, k):
    (a,) = states
    return (jnp.maximum(a, jnp.max(x)) + k,)


def _t_shift(states, x, k):
    (a,) = states
    return (torch.maximum(a, torch.amax(x)) + k,)


def _t_inplace(states, x):
    (a,) = states
    return (a.copy_(torch.maximum(a, torch.amax(x))),)


@pytest.mark.parametrize("donate", [False, True])
def test_eager_transform_matches_jax(donate):
    x = np.random.default_rng(1).random(5).astype(np.float32)
    a = torch.full((), 0.25)
    (want,) = jfuse.fused_transform(_j_shift, (jnp.float32(0.25),), (jnp.asarray(x),), (3.0,))
    (got,) = tfuse.fused_transform(_t_shift, (a,), (torch.from_numpy(x),), (3.0,), donate=donate)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL)
    assert (got is a) == donate
    # a kernel that writes the state itself hands it back untouched
    b = torch.full((), 0.25)
    (same,) = tfuse.fused_transform(_t_inplace, (b,), (torch.from_numpy(x),), donate=donate)
    assert same is b and float(b) == float(x.max())


def test_eager_group_matches_jax_and_materializes_placeholders():
    x = np.random.default_rng(2).random(5).astype(np.float32)
    jplans = [(_two, (jnp.float32(0.0), jnp.float32(0.0)), (jnp.asarray(x),), ()),
              (_j_shift, (jnp.float32(1.0),), (jnp.asarray(x),), (1.0,), True)]
    padded = tbucket.Padded(torch.from_numpy(x), (8,))
    tplans = [(_t_two, (torch.zeros(()), torch.zeros(())), (padded,), ()),
              (_t_shift, (torch.ones(()),), (torch.from_numpy(x),), (1.0,), True)]
    want = jfuse.fused_accumulate_group(jplans)
    got = tfuse.fused_accumulate_group(tplans, donate=True)
    for gs, ws in zip(got, want):
        for g, w in zip(gs, ws):
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=RTOL)


def test_graphed_update_refuses_cpu_states():
    with pytest.raises(ValueError, match="CUDA tensor states"):
        tfuse.fused_accumulate(_t_one, (torch.zeros(3),), (torch.ones(3),), donate=True,
                               graph=True)
    assert not tfuse.graphed_update_possible([TM.MulticlassAccuracy(device=CPU)])
    with tconfig.update_donation(True):
        assert not tfuse.graphed_update_possible([TM.MulticlassAccuracy(device=CPU)])
    assert tfuse.graph_stats()["captures"] == 0


def test_zero_outside_clears_exactly_the_old_region_past_the_new_one():
    static = torch.ones(6, 5)
    tfuse._zero_outside(static, (6, 5), (4, 2))
    want = torch.zeros(6, 5)
    want[:4, :2] = 1
    assert torch.equal(static, want)
    static = torch.zeros(6, 5)
    static[:3, :4] = 1
    tfuse._zero_outside(static, (3, 4), (5, 1))  # grows on one axis, shrinks on the other
    want = torch.zeros(6, 5)
    want[:3, :1] = 1
    assert torch.equal(static, want)


# ------------------------------------------------------ update_collection


def _panel(mod, device_kw):
    return {
        "acc": mod.MulticlassAccuracy(**device_kw),
        "acc_macro": mod.MulticlassAccuracy(average="macro", num_classes=7, **device_kw),
        "f1": mod.MulticlassF1Score(num_classes=7, average="macro", **device_kw),
        "cm": mod.MulticlassConfusionMatrix(7, **device_kw),
    }


def _panel_stream(mod, toolkit, device_kw, sizes, seed, bucketing, convert):
    metrics = _panel(mod, device_kw)
    rng = np.random.default_rng(seed)
    with bucketing():
        for n in sizes:
            x = rng.random((n, 7)).astype(np.float32)
            y = rng.integers(0, 7, n).astype(np.int32)
            toolkit.update_collection(metrics, convert(x), convert(y))
    return metrics


def test_bucketed_panel_matches_unbucketed_and_jax():
    sizes = [32, 17, 3, 32, 9]
    t = torch.from_numpy
    plain = _panel_stream(TM, ttoolkit, {"device": CPU}, sizes, 3,
                          lambda: tconfig.shape_bucketing(False), t)
    bucketed = _panel_stream(TM, ttoolkit, {"device": CPU}, sizes, 3, tconfig.shape_bucketing, t)
    theirs = _panel_stream(JM, jtoolkit, {}, sizes, 3, jconfig.shape_bucketing, lambda a: a)
    for name in plain:
        got, base = numpy_state_dict(bucketed[name]), numpy_state_dict(plain[name])
        want = {k: np.asarray(v) for k, v in theirs[name].state_dict().items()}
        for k in got:
            np.testing.assert_array_equal(got[k], base[k])
            np.testing.assert_array_equal(got[k], want[k])


class _Record:
    """Records the groups ``fused_accumulate_group`` receives."""

    def __init__(self, module, monkeypatch):
        self.groups = []
        real = module.fused_accumulate_group

        def spy(plans, **kwargs):
            self.groups.append([getattr(p[0], "__name__", str(p[0])) for p in plans])
            return real(plans, **kwargs)

        monkeypatch.setattr(module, "fused_accumulate_group", spy)


def _mixed_panel(mod, device_kw):
    return [
        mod.BinaryAccuracy(**device_kw),
        mod.BinaryNormalizedEntropy(**device_kw),  # no masked twin: the plain group
        mod.BinaryRecall(**device_kw),
        mod.StreamingBinaryAUROC(num_bins=64, **device_kw),  # no masked twin either
        mod.BinaryAUROC(**device_kw),  # buffered: no plan, updates itself
    ]


@pytest.mark.parametrize("bucketing", [False, True])
def test_update_collection_groups_like_jax(monkeypatch, bucketing):
    rng = np.random.default_rng(4)
    x = rng.random(11).astype(np.float32)
    y = rng.integers(0, 2, 11).astype(np.int32)
    trec, jrec = _Record(tfuse, monkeypatch), _Record(jfuse, monkeypatch)
    tpanel, jpanel = _mixed_panel(TM, {"device": CPU}), _mixed_panel(JM, {})
    with tconfig.shape_bucketing(bucketing), jconfig.shape_bucketing(bucketing):
        ttoolkit.update_collection(tpanel, torch.from_numpy(x), torch.from_numpy(y))
        jtoolkit.update_collection(jpanel, x, y)
    assert len(trec.groups) == len(jrec.groups) == (2 if bucketing else 1)
    for tg, jg in zip(trec.groups, jrec.groups):
        assert len(tg) == len(jg) == (2 if bucketing else 4)
        assert [n.endswith("_masked") for n in tg] == [n.endswith("_masked") for n in jg]
    for tm, jm in zip(tpanel, jpanel):
        for k, v in numpy_state_dict(tm).items():
            np.testing.assert_allclose(np.asarray(v, dtype=np.float64),
                                       np.asarray(jm.state_dict()[k], dtype=np.float64), rtol=RTOL)


def test_update_collection_pads_and_converts_each_input_once(monkeypatch):
    pads, conversions = [], []
    real_pad, real_conv = tbucket._pad_to, tconvert._to_torch_impl

    def count_pad(arg, shape, cache):
        out = real_pad(arg, shape, cache)
        pads.append(id(out))
        return out

    def count_conv(x, **kwargs):
        conversions.append(id(x))
        return real_conv(x, **kwargs)

    monkeypatch.setattr(tbucket, "_pad_to", count_pad)
    monkeypatch.setattr(tconvert, "_to_torch_impl", count_conv)
    rng = np.random.default_rng(5)
    x, y = rng.random((13, 6)).astype(np.float32), rng.integers(0, 6, 13).astype(np.int32)
    panel = [TM.MulticlassAccuracy(device=CPU),
             TM.MulticlassPrecision(num_classes=6, average=None, device=CPU),
             TM.MulticlassConfusionMatrix(6, device=CPU)]
    with tconfig.shape_bucketing():
        ttoolkit.update_collection(panel, x, y)
    assert len(set(pads)) == 2  # one pad each for the scores and the targets
    assert len(conversions) == 2  # the numpy scores and targets, converted once each
    before = len(conversions)
    panel[0].update(x, y)  # outside a panel: no sharing
    assert len(conversions) == before + 2


def test_update_collection_never_writes_its_inputs():
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.random((10, 4)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 4, 10).astype(np.int64))
    x0, y0 = x.clone(), y.clone()
    panel = [TM.MulticlassAccuracy(device=CPU), TM.MulticlassF1Score(device=CPU),
             TM.MulticlassConfusionMatrix(4, device=CPU), TM.MulticlassAUROC(num_classes=4, device=CPU)]
    with tconfig.shape_bucketing(), tconfig.update_donation(True):
        for _ in range(2):
            ttoolkit.update_collection(panel, x, y)
    assert torch.equal(x, x0) and torch.equal(y, y0)


class _Mismatched(Metric[torch.Tensor]):
    """A plan whose two ragged arguments disagree: ``apply_bucketing``
    rejects it while the panel is being planned."""

    def __init__(self):
        super().__init__(device=CPU)
        self._add_state("total", torch.zeros(()), merge=MergeKind.SUM)

    def _update_plan(self, input, target):
        return UpdatePlan(lambda a, b: torch.sum(a), ("total",), (input, target[:-1]),
                          masked_kernel=lambda a, b, v: torch.sum(a),
                          batch_axes=(("batch",), ("batch",)))

    def update(self, input, target):
        return self._apply_update_plan(self._update_plan(input, target))

    def compute(self):
        return self.total


@pytest.mark.parametrize("reject", ["input_check", "bucket_axes"])
def test_rejected_batch_changes_no_metric(reject):
    rng = np.random.default_rng(7)
    x, y = rng.random((9, 3)).astype(np.float32), rng.integers(0, 3, 9).astype(np.int32)
    panel = [TM.MulticlassAccuracy(device=CPU), TM.BinaryAUROC(device=CPU),
             TM.MulticlassF1Score(num_classes=3, average="macro", device=CPU)]
    with tconfig.shape_bucketing():
        ttoolkit.update_collection(panel[:1] + panel[2:], x, y)
        panel[1].update(x[:, 0], (y == 0).astype(np.int32))
        before = [numpy_state_dict(m) for m in panel]
        bad = TM.MulticlassConfusionMatrix(4, device=CPU) if reject == "input_check" else _Mismatched()
        with pytest.raises(ValueError):
            ttoolkit.update_collection(panel[:1] + [bad] + panel[2:], x, y)
    for m, b in zip(panel, before):
        for k, v in numpy_state_dict(m).items():
            np.testing.assert_array_equal(np.asarray(v), np.asarray(b[k]))


# ------------------------------------------- one plan runner, two callers


def _scores_labels(rng, n):
    s = rng.random(n).astype(np.float32)
    return torch.from_numpy(s), torch.from_numpy((rng.random(n) < s).astype(np.float32))


# (factory, batch) of every plan-bearing class the panels use, in the
# form its ``_update_plan`` returns
_PLAN_CLASSES = {
    # tuple plans
    "ne": (lambda: TM.BinaryNormalizedEntropy(device=CPU), _scores_labels),
    "ctr": (lambda: TM.ClickThroughRate(device=CPU), lambda rng, n: _scores_labels(rng, n)[1:]),
    "calibration": (lambda: TM.WeightedCalibration(device=CPU), _scores_labels),
    "mean": (lambda: TM.Mean(device=CPU), lambda rng, n: (torch.from_numpy(rng.random(n)),)),
    "sum": (lambda: TM.Sum(device=CPU), lambda rng, n: (torch.from_numpy(rng.random(n)),)),
    "psnr": (
        lambda: TM.PeakSignalNoiseRatio(data_range=1.0, device=CPU),
        lambda rng, n: tuple(torch.from_numpy(rng.random((n, 2, 3, 3)).astype(np.float32))
                             for _ in range(2)),
    ),
    # UpdatePlans
    "accuracy": (
        lambda: TM.MulticlassAccuracy(device=CPU),
        lambda rng, n: (torch.from_numpy(rng.random((n, 5)).astype(np.float32)),
                        torch.from_numpy(rng.integers(0, 5, n))),
    ),
    "perplexity": (
        lambda: TM.Perplexity(ignore_index=-100, device=CPU),
        lambda rng, n: (torch.from_numpy(rng.standard_normal((n, 6, 11)).astype(np.float32)),
                        torch.from_numpy(rng.integers(0, 11, (n, 6)))),
    ),
    "auroc": (lambda: TM.StreamingBinaryAUROC(num_bins=64, device=CPU), _scores_labels),
}


@pytest.mark.parametrize("bucketing", [False, True])
@pytest.mark.parametrize("name", list(_PLAN_CLASSES))
def test_lone_update_and_panel_leave_the_same_states(name, bucketing):
    """``update()`` and ``update_collection`` of the one metric run its
    plan (tuple or ``UpdatePlan``) through the same runner: a ragged
    stream leaves bitwise-equal states, with bucketing on and off."""
    factory, batch = _PLAN_CLASSES[name]
    rng = np.random.default_rng(17)
    lone, panel = factory(), factory()
    assert lone._update_plan(*batch(rng, 4)) is not None
    with tconfig.shape_bucketing(bucketing):
        for n in [13, 16, 5, 13]:
            args = batch(rng, n)
            lone.update(*args)
            ttoolkit.update_collection([panel], *args)
    got, want = numpy_state_dict(lone), numpy_state_dict(panel)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


class _ListPlan(Metric[torch.Tensor]):
    """A plan of neither form: a list where the tuple goes."""

    def __init__(self):
        super().__init__(device=CPU)
        self._add_state("total", torch.zeros(()), merge=MergeKind.SUM)

    def _update_plan(self, input):
        return [torch.sum, ("total",), (input,)]

    def update(self, input):
        return self._apply_update_plan(self._update_plan(input))

    def compute(self):
        return self.total


def test_a_plan_of_another_type_raises_type_error():
    metric = _ListPlan()
    with pytest.raises(TypeError, match="_ListPlan._update_plan returned a list"):
        metric.update(torch.ones(3))
    with pytest.raises(TypeError, match="_ListPlan"):
        ttoolkit.update_collection([TM.Sum(device=CPU), metric], torch.ones(3))
    assert float(metric.total) == 0.0


# -------------------------------------------------------------- donation


def test_donation_default_follows_the_metric_device(monkeypatch):
    monkeypatch.setattr(tconfig, "_update_donation", None)  # whatever the env says
    assert tconfig.update_donation_enabled(torch.device("cpu")) is False
    assert tconfig.update_donation_enabled(torch.device("cuda", 0)) is True
    assert tconfig.update_donation_enabled("cuda") is True
    assert tconfig.update_donation_enabled(None) is True  # None means the card
    with tconfig.update_donation(True):
        assert tconfig.update_donation_enabled("cpu") is True
        assert TM.Sum(device=CPU)._donation_active() is True
    with tconfig.update_donation(False):
        assert tconfig.update_donation_enabled("cuda:0") is False
    assert TM.Sum(device=CPU)._donation_active() is False


@pytest.mark.parametrize("raw,want", [("1", True), ("on", True), ("0", False), ("no", False),
                                      ("", None), ("maybe", None)])
def test_donation_env_spellings_match_jax(monkeypatch, raw, want):
    monkeypatch.setenv("TORCHEVAL_TPU_UPDATE_DONATION", raw)
    assert tconfig._env_donation() is want
    # the JAX package resolves an unset or unknown value by its backend, CPU here
    assert jconfig._resolve_update_donation() is bool(want)


def test_compute_shield_keeps_a_returned_value_under_donation(monkeypatch):
    monkeypatch.setattr(tconfig, "_update_donation", None)  # whatever the env says
    with tconfig.update_donation(True):
        metric = TM.Sum(device=CPU)
        metric.update(torch.tensor([1.0, 2.0]))
        state = metric.weighted_sum
        value = metric.compute()
        assert value is not state
        metric.update(torch.tensor([4.0]))
        assert metric.weighted_sum is state  # the update was in place
        assert float(value) == 3.0 and float(metric.compute()) == 7.0
    plain = TM.Sum(device=CPU).update(torch.tensor([1.0]))
    assert plain.compute() is plain.weighted_sum  # no donation: no copy


def test_compute_shield_matches_the_jax_shield_on_tuples():
    with tconfig.update_donation(True), jconfig.update_donation(True):
        tm = TM.BinaryBinnedPrecisionRecallCurve(threshold=5, device=CPU)
        jm = JM.BinaryBinnedPrecisionRecallCurve(threshold=5)
        x, y = np.array([0.1, 0.7, 0.4], np.float32), np.array([0, 1, 1], np.int32)
        tm.update(x, y)
        jm.update(x, y)
        tout, jout = tm.compute(), jm.compute()
        assert tout[2] is not tm.threshold
        for t, j in zip(tout, jout):
            np.testing.assert_allclose(_np(t), np.asarray(j), rtol=RTOL)


def test_reset_under_donation_keeps_the_state_tensors(monkeypatch):
    monkeypatch.setattr(tconfig, "_update_donation", None)  # whatever the env says
    with tconfig.update_donation(True):
        metric = TM.MulticlassAccuracy(average="macro", num_classes=3, device=CPU)
        metric.update(torch.tensor([0, 1, 2]), torch.tensor([0, 1, 1]))
        ids = (id(metric.num_correct), id(metric.num_total))
        metric.reset()
        assert (id(metric.num_correct), id(metric.num_total)) == ids
        assert float(metric.num_total.sum()) == 0.0
        snapshot = metric.state_dict()
        metric.update(torch.tensor([0]), torch.tensor([0]))
        assert float(snapshot["num_total"].sum()) == 0.0  # state_dict copies
    metric = TM.MulticlassAccuracy(device=CPU).update(torch.tensor([0]), torch.tensor([0]))
    state = metric.num_total
    metric.reset()
    assert metric.num_total is not state  # without donation reset replaces


# ------------------------------------- the graph bookkeeping, emulated on the CPU


class _FakeStream:
    cuda_stream = 7

    def wait_stream(self, other):
        pass


class _FakeGraph:
    """A "graph" that records the body it was captured with and re-runs it
    on replay: on the CPU nothing runs at capture, as on the card. A card's
    replay runs no Python, so the body's own launch counts are held out:
    ``_fuse`` adds the capture's."""

    body = None

    def replay(self):
        with tkernels.held_launches():
            self.body()


@pytest.fixture
def emulated_graphs(monkeypatch):
    """``_fuse``'s graph path on CPU tensors: ``torch.cuda``'s stream,
    graph and pool calls faked, ``_record`` storing the body instead of
    capturing it, donation on."""
    import contextlib

    stream = _FakeStream()
    monkeypatch.setattr(tfuse, "_GRAPH_DEVICE_TYPE", "cpu")
    # a fake graph's body holds its states, which a captured graph does
    # not: keep the emulated graphs out of the process-wide tables
    for name in ("_SIDE_STREAMS", "_GRAPHS", "_SIGHTINGS", "_BY_STATE", "_POOLS"):
        monkeypatch.setattr(tfuse, name, {})
    monkeypatch.setattr(tfuse, "_STATS", dict.fromkeys(tfuse._STATS, 0))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: stream)
    monkeypatch.setattr(tfuse, "_stream_id", lambda index: stream.cuda_stream)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", object)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)

    def record(graph, pool, body):
        graph.body = body
        return None

    monkeypatch.setattr(tfuse, "_record", record)
    with tconfig.update_donation(True):
        yield tfuse


def _captures():
    return tfuse.graph_stats()["captures"]


def test_emulated_graphs_replay_a_bucket_at_every_valid_count(emulated_graphs):
    """The static inputs are refilled per call: extents that shrink and
    grow within one bucket (the tail zeroed each time) give the eager
    panel's states bitwise, one capture a bucket and none on a second
    pass."""
    rng = np.random.default_rng(8)
    sizes = [64, 37, 60, 3, 7, 64, 5, 33]
    graphed, eager = _panel(TM, {"device": CPU}), _panel(TM, {"device": CPU})
    c0 = _captures()
    for rnd in range(2):
        for n in sizes:
            x = torch.from_numpy(rng.random((n, 7)).astype(np.float32))
            y = torch.from_numpy(rng.integers(0, 7, n).astype(np.int64))
            with tconfig.shape_bucketing():
                ttoolkit.update_collection(graphed, x, y)
            with tconfig.update_donation(False):  # eager: no repeated-signature graphs
                ttoolkit.update_collection(eager, x, y)
            for name in graphed:
                for k, v in graphed[name].state_dict().items():
                    assert torch.equal(v, eager[name].state_dict()[k]), (name, k, n)
        if rnd == 0:
            assert _captures() - c0 == 2  # buckets 64 and 8
            c0 = _captures()
    assert _captures() == c0


def test_emulated_graphs_zero_a_two_axis_tail(emulated_graphs):
    """Perplexity's batch and sequence axes shrink and grow independently
    inside one (8, 32) bucket; the static logits' stale rows and columns
    are zeroed before every replay."""
    rng = np.random.default_rng(9)
    graphed = TM.Perplexity(ignore_index=-100, device=CPU)
    eager = TM.Perplexity(ignore_index=-100, device=CPU)
    for rows, seq in [(8, 32), (3, 20), (6, 31), (2, 17), (8, 32), (1, 25)]:
        x = torch.from_numpy(rng.standard_normal((rows, seq, 11)).astype(np.float32))
        t = torch.from_numpy(rng.integers(0, 11, (rows, seq)))
        with tconfig.shape_bucketing():
            graphed.update(x, t)
        eager.update(x, t)
        assert int(graphed.num_total) == int(eager.num_total)
        np.testing.assert_allclose(float(graphed.sum_log_probs), float(eager.sum_log_probs),
                                   rtol=RTOL)
    assert tfuse.graph_stats()["captures"] == 1


def test_emulated_graphs_survive_reset_and_follow_new_states(emulated_graphs):
    metric = TM.MulticlassAccuracy(average="macro", num_classes=4, device=CPU)
    x, y = torch.rand(5, 4), torch.randint(0, 4, (5,))
    with tconfig.shape_bucketing():
        metric.update(x, y)
        c0 = _captures()
        metric.reset()  # in place under donation: the graph still writes the states
        metric.update(x, y)
        assert _captures() == c0
        metric.load_state_dict(metric.state_dict())  # in place under donation too
        metric.update(x, y)
        assert _captures() == c0
        metric.merge_state([TM.MulticlassAccuracy(average="macro", num_classes=4, device=CPU)])
        metric.update(x, y)  # the merge made new state tensors: a new graph
        assert _captures() == c0 + 1
    want = TM.MulticlassAccuracy(average="macro", num_classes=4, device=CPU)
    want.update(x, y).update(x, y).update(x, y)
    for k, v in metric.state_dict().items():
        assert torch.equal(v, want.state_dict()[k])


def test_graphs_are_dropped_when_a_state_dies(monkeypatch):
    """A graph writes its states' memory: when any of them is freed, the
    graph (and, with its last graph, the pool) goes with it."""
    import gc
    from types import SimpleNamespace

    for name in ("_GRAPHS", "_BY_STATE", "_POOLS"):
        monkeypatch.setattr(tfuse, name, {})
    a, b = torch.zeros(3), torch.zeros(2)
    for key in ("k1", "k2"):
        tfuse._POOLS.setdefault("pool", [object(), 0])[1] += 1
        tfuse._register(key, SimpleNamespace(state_ids=(id(a), id(b)), pool_key="pool"), (a, b))
    assert set(tfuse._GRAPHS) == {"k1", "k2"} and tfuse._POOLS["pool"][1] == 2
    del a
    gc.collect()
    assert tfuse._GRAPHS == {} and tfuse._POOLS == {}
    assert tfuse._BY_STATE[id(b)] == set()


def test_emulated_graphs_run_eagerly_while_a_state_changes_shape(emulated_graphs):
    """A scalar MSE state meets its first 2-D batch: that call runs eagerly
    out of place (no capture), the next captures."""
    rng = np.random.default_rng(10)
    graphed, eager = TM.MeanSquaredError(device=CPU), TM.MeanSquaredError(device=CPU)
    c0 = _captures()
    for i, n in enumerate([9, 12, 16]):
        x = torch.from_numpy(rng.random((n, 3)).astype(np.float32))
        y = torch.from_numpy(rng.random((n, 3)).astype(np.float32))
        with tconfig.shape_bucketing():
            graphed.update(x, y)
        eager.update(x, y)
        if i == 0:
            assert _captures() == c0 and graphed.sum_squared_error.shape == (3,)
    assert _captures() == c0 + 1
    for k, v in graphed.state_dict().items():
        np.testing.assert_allclose(_np(v), _np(eager.state_dict()[k]), rtol=RTOL)


def test_emulated_capture_failure_raises(emulated_graphs, monkeypatch):
    monkeypatch.setattr(tfuse, "_record", lambda graph, pool, body: RuntimeError("refused"))
    metric = TM.BinaryAccuracy(device=CPU)
    before = numpy_state_dict(metric)
    with tconfig.shape_bucketing(), pytest.raises(RuntimeError, match="capture of a bucketed"):
        metric.update(torch.rand(5), torch.randint(0, 2, (5,)))
    for k, v in numpy_state_dict(metric).items():
        np.testing.assert_array_equal(v, before[k])  # nothing ran


def test_fill_leaves_exactly_the_zero_padded_batch(emulated_graphs):
    """The static inputs hold each call's batch zero-padded to the bucket,
    whatever the previous call left there: the twins multiply by the
    mask, so a stale NaN would leak into a state."""
    rng = np.random.default_rng(11)
    shape = (8, 6, 3)
    first = tbucket.Padded(torch.full((8, 6, 3), float("nan")), shape)
    entry = tfuse._Graph([tfuse._alloc(first, torch.device(CPU))], [first], (), None)
    tfuse._fill(entry, [first])
    for rows, cols in [(3, 6), (8, 2), (5, 4), (1, 1), (8, 6), (2, 5)]:
        src = torch.from_numpy(rng.random((rows, cols, 3)).astype(np.float32))
        padded = tbucket.Padded(src, shape)
        tfuse._fill(entry, [padded])
        assert torch.equal(entry.statics[0], padded.materialize())
    valid = tbucket.ValidSizes((5, 9), torch.device(CPU))
    entry = tfuse._Graph([tfuse._alloc(valid, torch.device(CPU))], [valid], (), None)
    tfuse._fill(entry, [valid])
    assert entry.statics[0].tolist() == [5, 9] and entry.statics[0].dtype == torch.int32


def test_emulated_graphed_group_is_one_replay_range(emulated_graphs):
    """With the recorder on, a graphed group's replay (its fill included)
    is one ``torcheval.replay`` range inside ``torcheval.update_collection``,
    with a plan range a metric and no accumulate range; a capture still
    names the panel as its site."""
    import json
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from torcheval_tpu_torch import obs

    graphed = _panel(TM, {"device": CPU})
    x, y = torch.rand(37, 7), torch.randint(0, 7, (37,))
    obs.enable()
    obs.recorder().reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof, tconfig.shape_bucketing():
            for _ in range(2):  # a capture, then a replay of it
                ttoolkit.update_collection(graphed, x, y)
        compiles = [e for e in obs.recorder().log.tail() if e.kind == "compile"]
    finally:
        obs.disable()
        obs.recorder().reset()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    names = [e["name"] for e in events
             if e.get("cat") == "user_annotation" and e["name"].startswith("torcheval.")]
    assert names.count("torcheval.update_collection") == 2
    assert names.count("torcheval.replay") == 2
    assert sorted(n for n in names if n.startswith("torcheval.plan/")) == sorted(
        f"torcheval.plan/{type(m).__name__}" for m in graphed.values() for _ in range(2))
    assert not any(n.startswith("torcheval.accumulate/") for n in names)
    assert [c.site for c in compiles] == ["torcheval.update_collection"]


# -------------- the unbucketed group's repeated-signature graphs, emulated on the CPU


def _stream_panels():
    """The Criteo stream panel: four metrics on (scores, labels), CTR on
    the labels alone (two ``update_collection`` calls, two groups)."""
    pair = {
        "ne": TM.BinaryNormalizedEntropy(device=CPU),
        "calibration": TM.WeightedCalibration(device=CPU),
        "auroc": TM.StreamingBinaryAUROC(num_bins=64, device=CPU),
        "auprc": TM.StreamingBinaryAUPRC(num_bins=64, device=CPU),
    }
    return pair, {"ctr": TM.ClickThroughRate(device=CPU)}


def _stream_batch(rng, n):
    s = rng.random(n).astype(np.float32)
    return torch.from_numpy(s), torch.from_numpy((rng.random(n) < s).astype(np.float32))


def _stream_update(panels, s, y):
    pair, ctr = panels
    ttoolkit.update_collection(pair, s, y)
    ttoolkit.update_collection(ctr, y)


def _stats_since(before):
    now = tfuse.graph_stats()
    return {k: now[k] - before[k] for k in before if k not in ("graphs", "pools")}


def _assert_panels_equal(got, want):
    for g, w in zip(got, want):
        for name in g:
            for k, v in g[name].state_dict().items():
                assert torch.equal(v, w[name].state_dict()[k]), (name, k)


@pytest.mark.parametrize("name", ["ctr", "auroc"])
def test_lone_unbucketed_updates_never_graph(emulated_graphs, name):
    """A lone ``update()`` runs an unbucketed plan eagerly however often
    its signature repeats (``update_collection`` captures it on the second
    sighting, below): three identical calls add nothing to any count."""
    factory, batch = _PLAN_CLASSES[name]
    metric, args = factory(), batch(np.random.default_rng(18), 512)
    before = tfuse.graph_stats()
    for _ in range(3):
        metric.update(*args)
    got = _stats_since(before)
    assert got == dict.fromkeys(got, 0)


def test_stream_panel_graphs_on_the_second_sighting(emulated_graphs):
    """Each of the panel's two groups runs eagerly on its signature's
    first sighting, is captured (and replayed) on the second, and replays
    from the third on."""
    rng = np.random.default_rng(12)
    panels = _stream_panels()
    steps = []
    for _ in range(3):
        before = tfuse.graph_stats()
        _stream_update(panels, *_stream_batch(rng, 512))
        steps.append(_stats_since(before))
    zero = dict.fromkeys(steps[0], 0)
    assert steps[0] == dict(zero, eager_first_sighting=2)
    assert steps[1] == dict(zero, captures=2, replays=2)
    assert steps[2] == dict(zero, replays=2)


def test_repeated_graphs_keep_the_stream_panel_bitwise_eager(emulated_graphs):
    """Passes of full batches and a ragged tail, a ``reset()`` after each:
    the graphed panel's states equal those of the same batches with
    donation off, bitwise, and the graphs (batch and tail, two groups)
    survive the resets."""
    rng = np.random.default_rng(13)
    graphed, eager = _stream_panels(), _stream_panels()
    captures = []
    for _ in range(3):
        for n in [512] * 4 + [77]:
            s, y = _stream_batch(rng, n)
            _stream_update(graphed, s, y)
            with tconfig.update_donation(False):
                _stream_update(eager, s, y)
        _assert_panels_equal(graphed, eager)
        for panel in graphed + eager:
            for m in panel.values():
                m.reset()
        captures.append(tfuse.graph_stats()["captures"])
    assert captures == [2, 4, 4]  # the tail repeats in the second pass
    _assert_panels_equal(graphed, eager)


def test_repeated_group_over_the_input_cap_stays_eager(emulated_graphs):
    """Inputs a replay would copy are capped in total: one byte over runs
    eagerly on every call, counted ``over_bytes``; at the cap it graphs."""
    per_sample = 8  # float32 scores and labels
    stats = {}
    for extra in (1, 0):
        n = tfuse.REPEATED_INPUT_CAP_BYTES // per_sample + extra
        panel = {"ne": TM.BinaryNormalizedEntropy(device=CPU)}
        s = torch.rand(n, generator=torch.Generator().manual_seed(extra))
        y = (s > 0.5).float()
        before = tfuse.graph_stats()
        for _ in range(3):
            ttoolkit.update_collection(panel, s, y)
        stats[extra] = _stats_since(before)
    assert stats[1]["eager_over_bytes"] == 3
    assert stats[1]["captures"] == stats[1]["replays"] == 0
    assert stats[0]["eager_over_bytes"] == 0
    assert (stats[0]["captures"], stats[0]["replays"]) == (1, 2)


def test_repeated_capture_budget_holds(emulated_graphs):
    """A set of states captures at most ``REPEATED_CAPTURE_BUDGET``
    signatures; past them its repeated signatures run eagerly (bitwise as
    with donation off), and another set of states has its own budget."""
    budget = tfuse.REPEATED_CAPTURE_BUDGET
    sizes = list(range(10, 13 + budget))
    rng = np.random.default_rng(14)
    graphed, eager = {"ctr": TM.ClickThroughRate(device=CPU)}, {"ctr": TM.ClickThroughRate(device=CPU)}
    before = tfuse.graph_stats()
    for _ in range(3):
        for n in sizes:
            y = torch.from_numpy((rng.random(n) < 0.3).astype(np.float32))
            ttoolkit.update_collection(graphed, y)
            with tconfig.update_donation(False):
                ttoolkit.update_collection(eager, y)
    got = _stats_since(before)
    over = len(sizes) - budget
    assert got["eager_first_sighting"] == len(sizes)
    assert got["captures"] == budget and got["replays"] == 2 * budget
    assert got["eager_budget"] == 2 * over
    _assert_panels_equal([graphed], [eager])
    fresh = {"ctr": TM.ClickThroughRate(device=CPU)}
    before = tfuse.graph_stats()
    for _ in range(2):
        ttoolkit.update_collection(fresh, torch.ones(sizes[-1]))
    assert _stats_since(before)["captures"] == 1


def test_failed_repeated_capture_runs_eagerly_and_stays_eager(emulated_graphs, monkeypatch):
    """A refused capture of an unbucketed group raises nothing: that call
    runs eagerly, counted ``capture_failed``, with a warning that names the
    kernels and the cause, and so does every later call of the signature,
    without another try. (A bucketed capture still raises:
    ``test_emulated_capture_failure_raises``.)"""
    tries = []

    def refuse(graph, pool, body):
        tries.append(graph)
        return RuntimeError("refused")

    monkeypatch.setattr(tfuse, "_record", refuse)
    rng = np.random.default_rng(15)
    graphed, eager = _stream_panels(), _stream_panels()
    before = tfuse.graph_stats()
    for i in range(4):
        s, y = _stream_batch(rng, 512)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _stream_update(graphed, s, y)
        messages = [str(w.message) for w in caught if w.category is RuntimeWarning]
        assert len(messages) == (2 if i == 1 else 0)
        assert all("refused" in m and "runs eagerly" in m for m in messages)
        with tconfig.update_donation(False):
            _stream_update(eager, s, y)
    got = _stats_since(before)
    assert len(tries) == 2  # one try a group
    assert got["eager_first_sighting"] == 2 and got["eager_capture_failed"] == 2 * 3
    assert got["captures"] == got["replays"] == 0 and tfuse.graph_stats()["pools"] == 0
    _assert_panels_equal(graphed, eager)


def test_k1_launches_count_once_a_streaming_update_in_replays(emulated_graphs, monkeypatch):
    """``LAUNCHES["fused_auc_hist"]`` counts one K1 launch a streaming
    update whether the update ran eagerly, was captured or replayed: a
    capture's warm-up and recording are held out, and a replay adds what
    the warm-up launched. (K1 has no CPU form, so the streaming metrics'
    kernel here counts a launch as K1's wrapper does on the card.)"""
    from torcheval_tpu_torch.metrics.classification import streaming_auroc

    real = streaming_auroc.histogram_accumulate_kernel

    def counted(states, *args):
        tkernels.count_launch("fused_auc_hist")
        return real(states, *args)

    monkeypatch.setattr(streaming_auroc, "histogram_accumulate_kernel", counted)
    rng = np.random.default_rng(16)
    panels = _stream_panels()
    sizes = ([512] * 5 + [77]) * 2
    launches0, before = tkernels.LAUNCHES["fused_auc_hist"], tfuse.graph_stats()
    for n in sizes:
        _stream_update(panels, *_stream_batch(rng, n))
    got = _stats_since(before)
    # eager: the first sighting of the batch and of the tail, both groups
    assert got["captures"] == 4 and got["replays"] == 2 * len(sizes) - 4
    assert tkernels.LAUNCHES["fused_auc_hist"] - launches0 == 2 * len(sizes)


def test_held_launches_tally_apart_from_the_counts():
    before = tkernels.LAUNCHES["fused_auc_hist"]
    with tkernels.held_launches() as outer:
        tkernels.count_launch("fused_auc_hist")
        with tkernels.held_launches() as inner:
            tkernels.count_launch("fused_auc_hist")
            tkernels.count_launch("fused_auc_hist")
        tkernels.count_launch("fused_auc_hist")
    assert (outer, inner) == ({"fused_auc_hist": 2}, {"fused_auc_hist": 2})
    assert tkernels.LAUNCHES["fused_auc_hist"] == before
    tkernels.add_launches(inner)
    assert tkernels.LAUNCHES["fused_auc_hist"] == before + 2
    tkernels.LAUNCHES["fused_auc_hist"] = before
