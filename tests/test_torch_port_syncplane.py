"""The zero-stall sync plane (``torcheval_tpu_torch.syncplane``) and the
metric core's ``_state_epoch``, against the JAX package.

- ``publish`` copies: with donated (in-place) updates forced on, a rank
  publishes, updates again, and a read at that version still equals, bit
  for bit, a blocking sync over the states as they were at the publish
  (a plane that held the live tensors fails this);
- the ``DeterministicScheduler`` interleavings of publish, round and read
  never tear a generation;
- ``reset``/``load_state_dict`` bump ``_state_epoch`` where the JAX
  package bumps it, and a post-reset read falls back to version 0;
- ``plane=`` on the toolkit serves the plane's read;
- over ``ThreadWorld(4)`` the port's plane and the JAX package's, fed the
  same numpy data, read the same values (bitwise) with the same staleness
  provenance;
- the armed update/publish path issues no gather on the serving group,
  and an armed thread runs rounds until ``close``.
"""

from __future__ import annotations

import copy
import time
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as JM
import torcheval_tpu.syncplane as JP
import torcheval_tpu_torch.metrics as PM
import torcheval_tpu_torch.syncplane as PP
from torcheval_tpu.utils.test_utils import ThreadWorld as JThreadWorld
from torcheval_tpu_torch import config
from torcheval_tpu_torch.distributed import ProcessGroup
from torcheval_tpu_torch.metrics import toolkit
from torcheval_tpu_torch.utils.test_utils import DeterministicScheduler, ThreadWorld

CPU = "cpu"


def _data(rank, step, n=257):
    r = np.random.default_rng(1000 * rank + step)
    s = r.uniform(0, 1, n).astype(np.float32)
    y = (r.uniform(0, 1, n) < s).astype(np.float32)
    x = r.standard_normal((n, 6)).astype(np.float32)
    t = r.integers(0, 6, n)
    return s, y, x, t


def _panel(P, **kw):
    return {
        "mean": P.Mean(**kw),
        "auroc": P.BinaryAUROC(**kw),
        "cm": P.MulticlassConfusionMatrix(6, **kw),
        "hist": P.HistogramBinnedAUROC(threshold=64, **kw),
    }


def _feed(panel, rank, step, jax_side=False):
    s, y, x, t = _data(rank, step)
    conv = jnp.asarray if jax_side else torch.from_numpy
    panel["mean"].update(conv(s))
    panel["auroc"].update(conv(s), conv(y))
    panel["cm"].update(conv(x), conv(t))
    panel["hist"].update(conv(s), conv(y))


def _bits(v):
    if isinstance(v, tuple):  # HistogramBinnedAUROC: (auroc, thresholds)
        return b"".join(_bits(x) for x in v)
    return np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v).tobytes()


def test_all_lists_match():
    assert PP.__all__ == JP.__all__


def test_state_epoch_bumps_where_jax_bumps():
    pm, jm = PM.Mean(device=CPU), JM.Mean()
    assert pm._state_epoch == jm._state_epoch == 0
    pm.update(torch.tensor([1.0, 2.0]))
    jm.update(jnp.asarray([1.0, 2.0]))
    assert pm._state_epoch == jm._state_epoch == 0
    pm.reset()
    jm.reset()
    donor_p, donor_j = PM.Mean(device=CPU), JM.Mean()
    pm.load_state_dict(donor_p.state_dict())
    jm.load_state_dict(donor_j.state_dict())
    assert pm._state_epoch == jm._state_epoch == 2
    from torcheval_tpu_torch.table import MetricTable

    t = MetricTable("ctr", device=CPU)
    t.ingest(np.arange(5), torch.ones(5))
    e = t._state_epoch
    t.load_state_dict(t.state_dict())
    assert t._state_epoch == e + 1
    t.reset()
    assert t._state_epoch == e + 2


class _Counting(ProcessGroup):
    """A serving group that counts the gathers issued through it."""

    def __init__(self, inner):
        self._inner, self.gathers = inner, 0

    world_size = property(lambda self: self._inner.world_size)
    rank = property(lambda self: self._inner.rank)
    ranks = property(lambda self: self._inner.ranks)

    def new_subgroup(self, ranks):
        return self._inner.new_subgroup(ranks)

    def allgather_object(self, obj):
        self.gathers += 1
        return self._inner.allgather_object(obj)

    def allgather_array(self, x):
        self.gathers += 1
        return self._inner.allgather_array(x)


def test_publish_update_read_is_the_published_state():
    """The aliasing pin: updates write the live states in place (donation
    forced on), yet the read at V equals a blocking sync over the states
    as they were when V's payload was published."""
    world = ThreadWorld(2)
    out = {}

    def body(g):
        panel = _panel(PM, device=CPU)
        counting = _Counting(g)
        _feed(panel, g.rank, 0)
        frozen = {k: toolkit.clone_metric(m) for k, m in panel.items()}
        plane = PP.SyncPlane(panel, counting)
        try:
            plane.publish()
            for step in (1, 2):  # in place, after the publish
                _feed(panel, g.rank, step)
            version = plane.run_round()
            read = plane.read()
            oracle = toolkit.get_synced_metric_collection(frozen, g)
            out[g.rank] = (
                version,
                {k: _bits(m.compute()) for k, m in read.items()},
                {k: _bits(m.compute()) for k, m in oracle.items()},
                counting.gathers,
                read["mean"].sync_provenance,
            )
        finally:
            plane.close()

    # the knob is process-wide: set it here, not in the rank threads
    with config.update_donation(True):
        world.run(body)
    for rank, (version, got, want, gathers, prov) in out.items():
        assert version == 1 and got == want, rank
        assert gathers == 0  # the rounds ride the plane's own communicator
        assert prov.version == 1 and prov.rounds_behind == 0 and tuple(prov.ranks) == (0, 1)


@pytest.mark.parametrize("seed", range(4))
def test_publish_read_swap_interleavings_never_tear(seed):
    coll = {"a": PM.Mean(device=CPU), "b": PM.Mean(device=CPU)}
    plane = PP.SyncPlane(coll)
    seen = []
    try:

        def publisher():
            for k in (1.0, 2.0, 3.0):
                coll["a"].reset()
                coll["b"].reset()
                coll["a"].update(torch.tensor([k]))
                coll["b"].update(torch.tensor([k]))
                plane.publish()
                plane.run_round()

        def reader():
            for _ in range(4):
                out = plane.read()
                seen.append((float(out["a"].compute()), float(out["b"].compute())))

        sched = DeterministicScheduler(seed=seed, trace=[PP])
        sched.spawn(publisher)
        sched.spawn(reader)
        sched.run()
    finally:
        plane.close()
    for a, b in seen:
        if not (np.isnan(a) or np.isnan(b)):
            assert a == b, seen


def test_reset_invalidates_and_toolkit_plane_form():
    coll = {"a": PM.Mean(device=CPU), "b": PM.Mean(device=CPU)}
    coll["a"].update(torch.tensor([3.0]))
    coll["b"].update(torch.tensor([5.0]))
    with PP.SyncPlane(coll) as plane:
        plane.publish()
        assert plane.run_round() == 1
        vals = toolkit.sync_and_compute_collection(coll, plane=plane)
        assert float(vals["a"]) == 3.0 and float(vals["b"]) == 5.0
        assert float(toolkit.sync_and_compute(coll["b"], plane=plane)) == 5.0
        with pytest.raises(ValueError, match="same live instance"):
            plane.read_collection({"a": PM.Mean(device=CPU)})
        coll["a"].reset()
        out = plane.read()
        assert out["a"].sync_provenance.version == 0  # cold: the snapshot predates the reset
        assert np.isnan(float(out["a"].compute()))
        assert plane.cold_reads == 1
        plane.publish()
        plane.run_round()
        assert plane.read()["a"].sync_provenance.version == 2


def _plane_run(world_cls, P, jax_side):
    world = world_cls(4)
    out = {}

    def body(g):
        kw = {} if jax_side else {"device": CPU}
        panel = _panel(P, **kw)
        plane = (JP if jax_side else PP).SyncPlane(panel, g)
        try:
            _feed(panel, g.rank, 0, jax_side)
            plane.publish()
            plane.run_round()
            _feed(panel, g.rank, 1, jax_side)
            plane.publish()
            plane.publish()
            read = plane.read()
            prov = read["cm"].sync_provenance
            out[g.rank] = (
                {k: _bits(m.compute()) for k, m in read.items()},
                (prov.version, prov.rounds_behind, tuple(prov.ranks), prov.world_size,
                 prov.degraded, prov.policy),
                plane.staleness()["rounds_behind"],
            )
        finally:
            plane.close()

    world.run(body)
    return out


def test_threadworld4_matches_the_jax_plane():
    got = _plane_run(ThreadWorld, PM, False)
    want = _plane_run(JThreadWorld, JM, True)
    for rank in range(4):
        assert got[rank][1] == want[rank][1] == (1, 2, (0, 1, 2, 3), 4, False, "raise")
        assert got[rank][2] == want[rank][2] == 2
        for name in ("cm", "mean", "hist"):
            assert got[rank][0][name] == want[rank][0][name], (rank, name)
        g = np.frombuffer(got[rank][0]["auroc"], np.float32)
        w = np.frombuffer(want[rank][0]["auroc"], np.float32)
        assert np.allclose(g, w, rtol=1e-6, atol=0)  # the curve's float sums


def test_armed_thread_runs_rounds_and_stops_on_close():
    coll = {"a": PM.Mean(device=CPU)}
    coll["a"].update(torch.tensor([4.0]))
    plane = PP.SyncPlane(coll, interval=0.02)
    try:
        plane.publish()
        deadline = time.monotonic() + 10.0
        while plane.version < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert plane.version >= 1 and plane.armed
        assert PP.current_plane() is plane
        from torcheval_tpu_torch.obs.counters import default_registry

        assert default_registry().read()["syncplane"]["armed"] == 1
    finally:
        plane.close()
    assert not plane.armed and PP.current_plane() is None
    plane.close()  # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        plane.publish()


def test_serving_path_issues_no_gather_and_fake_group_warns():
    class Fake(ProcessGroup):
        gathers = 0
        world_size = property(lambda self: 2)
        rank = property(lambda self: 0)

        def allgather_object(self, obj):
            self.gathers += 1
            return [obj, copy.deepcopy(obj)]

        def allgather_array(self, x):
            self.gathers += 1
            return [np.asarray(x), np.asarray(x).copy()]

    serving = Fake()
    coll = {"a": PM.Mean(device=CPU), "b": PM.Mean(device=CPU)}
    with pytest.warns(RuntimeWarning, match="dedicated plane communicator"):
        plane = PP.SyncPlane(coll, serving)
    try:
        for k in range(20):
            coll["a"].update(torch.tensor([float(k)]))
            plane.publish()
        assert serving.gathers == 0
    finally:
        plane.close()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        toolkit.sync_and_compute_collection(coll, serving)
    assert serving.gathers > 0
