"""torcheval_tpu_torch StreamingBinaryAUROC/AUPRC against the JAX
package's, on the same numpy streams. Unit-weight histogram states are
bitwise equal (every bin is an exact integer); weighted ones agree at
rtol 1e-5; AUC/AUPRC read off the histograms agree at atol 1e-6."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as JM
from torcheval_tpu.metrics import toolkit as jtoolkit
import torcheval_tpu_torch.metrics as TM
from torcheval_tpu_torch.metrics import toolkit as ttoolkit

CPU = "cpu"
BINS = 1024


def _stream(seed, tasks=None, batches=4, n=2500, weighted=False, lo=0.0, hi=1.0):
    rng = np.random.default_rng(seed)
    shape = (n,) if tasks is None else (tasks, n)
    out = []
    for _ in range(batches):
        u = rng.random(shape).astype(np.float32)
        s = (lo + u * (hi - lo)).astype(np.float32)
        t = (rng.random(shape) < u).astype(np.float32)
        w = rng.random(shape).astype(np.float32) if weighted else None
        out.append((s, t, w))
    return out


def _feed(m, stream):
    for s, t, w in stream:
        if w is None:
            m.update(s, t)
        else:
            m.update(s, t, w)
    return m


@pytest.mark.parametrize("cls", ["StreamingBinaryAUROC", "StreamingBinaryAUPRC"])
@pytest.mark.parametrize("tasks", [None, 3])
@pytest.mark.parametrize("bounds", [(0.0, 1.0), (-2.0, 6.0)], ids=str)
def test_stream_matches_jax_bitwise(cls, tasks, bounds):
    stream = _stream(1, tasks, lo=bounds[0], hi=bounds[1])
    kw = {"num_tasks": tasks or 1, "num_bins": BINS, "bounds": bounds}
    tm = _feed(getattr(TM, cls)(device=CPU, **kw), stream)
    jm = _feed(getattr(JM, cls)(**kw), stream)
    np.testing.assert_array_equal(tm.hist.numpy(), np.asarray(jm.hist))
    got, want = tm.compute().numpy(), np.asarray(jm.compute())
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("cls", ["StreamingBinaryAUROC", "StreamingBinaryAUPRC"])
def test_weighted_multitask_stream_matches_jax(cls):
    stream = _stream(2, 4, weighted=True)
    tm = _feed(getattr(TM, cls)(num_tasks=4, num_bins=BINS, device=CPU), stream)
    jm = _feed(getattr(JM, cls)(num_tasks=4, num_bins=BINS), stream)
    np.testing.assert_allclose(tm.hist.numpy(), np.asarray(jm.hist), rtol=1e-5)
    total_w = sum(w.astype(np.float64).sum() for _, _, w in stream)
    np.testing.assert_allclose(tm.hist.numpy().sum(), total_w, rtol=1e-5)
    np.testing.assert_allclose(tm.compute().numpy(), np.asarray(jm.compute()), atol=1e-6)


def test_merge_state_matches_jax_and_a_single_stream():
    stream = _stream(3, batches=6)
    t = [_feed(TM.StreamingBinaryAUROC(num_bins=BINS, device=CPU), stream[i::3]) for i in range(3)]
    j = [_feed(JM.StreamingBinaryAUROC(num_bins=BINS), stream[i::3]) for i in range(3)]
    single = _feed(TM.StreamingBinaryAUROC(num_bins=BINS, device=CPU), stream)
    t[0].merge_state(t[1:])
    j[0].merge_state(j[1:])
    np.testing.assert_array_equal(t[0].hist.numpy(), np.asarray(j[0].hist))
    assert torch.equal(t[0].hist, single.hist)
    assert torch.equal(t[0].compute(), single.compute())


def test_merge_refuses_mismatched_bounds():
    a = TM.StreamingBinaryAUROC(num_bins=BINS, device=CPU)
    b = TM.StreamingBinaryAUROC(num_bins=BINS, bounds=(0.0, 2.0), device=CPU)
    with pytest.raises(ValueError, match="different bounds"):
        a.merge_state([b])


@pytest.mark.parametrize(
    "kwargs",
    [{"num_tasks": 0}, {"num_bins": 1}, {"bounds": (1.0, 1.0)}, {"bounds": (2.0, 1.0)}],
)
def test_constructor_checks_match_jax(kwargs):
    with pytest.raises(ValueError):
        JM.StreamingBinaryAUROC(**kwargs)
    with pytest.raises(ValueError):
        TM.StreamingBinaryAUROC(device=CPU, **kwargs)


@pytest.mark.parametrize(
    "tasks, s_shape, t_shape, w_shape",
    [(1, (2, 10), (2, 10), None), (1, (10,), (9,), None), (3, (10,), (10,), None),
     (3, (2, 10), (2, 10), None), (1, (10,), (10,), (9,))],
)
def test_update_input_checks_match_jax(tasks, s_shape, t_shape, w_shape):
    s, t = np.zeros(s_shape, np.float32), np.zeros(t_shape, np.float32)
    w = None if w_shape is None else np.ones(w_shape, np.float32)
    with pytest.raises(ValueError):
        JM.StreamingBinaryAUROC(num_tasks=tasks).update(s, t, w)
    with pytest.raises(ValueError):
        TM.StreamingBinaryAUROC(num_tasks=tasks, device=CPU).update(s, t, w)


def test_reset_and_state_dict_copies():
    stream = _stream(4, batches=2)
    m = _feed(TM.StreamingBinaryAUPRC(num_bins=BINS, device=CPU), stream)
    snap = m.state_dict()
    _feed(m, stream)
    assert not torch.equal(snap["hist"], m.hist)
    m.reset()
    assert float(m.hist.sum()) == 0.0
    m.load_state_dict(snap)
    assert torch.equal(m.hist, snap["hist"])


def test_update_collection_with_streaming_metrics_matches_jax():
    stream = _stream(5, batches=3)
    tcoll = {"auroc": TM.StreamingBinaryAUROC(num_bins=BINS, device=CPU),
             "auprc": TM.StreamingBinaryAUPRC(num_bins=BINS, device=CPU)}
    jcoll = {"auroc": JM.StreamingBinaryAUROC(num_bins=BINS),
             "auprc": JM.StreamingBinaryAUPRC(num_bins=BINS)}
    for s, t, _ in stream:
        ttoolkit.update_collection(tcoll, s, t)
        jtoolkit.update_collection(jcoll, s, t)
    for name in tcoll:
        np.testing.assert_array_equal(tcoll[name].hist.numpy(), np.asarray(jcoll[name].hist))
        np.testing.assert_allclose(tcoll[name].compute().numpy(), np.asarray(jcoll[name].compute()), atol=1e-6)


def test_torch_and_numpy_inputs_agree():
    (s, t, _), = _stream(6, batches=1)
    a = TM.StreamingBinaryAUROC(num_bins=BINS, device=CPU).update(s, t)
    b = TM.StreamingBinaryAUROC(num_bins=BINS, device=CPU).update(
        torch.from_numpy(s), torch.from_numpy(t).to(torch.int64)
    )
    assert torch.equal(a.hist, b.hist)
