"""The streaming decode metrics of the port (``torcheval_tpu_torch.streaming``)
against the JAX package's (``torcheval_tpu.streaming``): the same numpy
steps through both, step by step and whole-sequence, bucketed and not,
with merges and ``state_dict`` cross-loads. Every counter is an integer,
so the comparisons are bitwise; perplexity's float32 chain is compared
bitwise too (both packages fold it sequentially); the n-gram overlap's
log/exp values at rtol 1e-6. ``_mix``: the device
fold (int64 holders, 16-bit-half multiplies) swept against the host fold
and the JAX package's uint32 fold."""

from __future__ import annotations

import doctest
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torcheval_tpu import streaming as J
from torcheval_tpu.streaming._mix import mix_seed_jnp, mix_step_jnp
from torcheval_tpu_torch import config
from torcheval_tpu_torch import streaming as T
from torcheval_tpu_torch.streaming._mix import MIX_SEED, mix_fold_int, mix_seed, mix_step
from torcheval_tpu_torch.utils.convert import load_numpy_state_dict, numpy_state_dict

CPU = "cpu"


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _jax_sd(m):
    return {k: (np.asarray(v) if not isinstance(v, (int, float)) else v) for k, v in m.state_dict().items()}


def _assert_same_states(port, jax_metric):
    want = _jax_sd(jax_metric)
    got = numpy_state_dict(port)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]), err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


# ---------------------------------------------------------------------- mix


def _device_fold(tokens):
    h = mix_seed(CPU)
    for t in tokens:
        h = mix_step(h, torch.tensor(t, dtype=torch.int32))
    return int(h)


def _jax_fold(tokens):
    h = mix_seed_jnp()
    for t in tokens:
        h = mix_step_jnp(h, jnp.asarray(t, jnp.int32))
    return int(h)


@pytest.mark.parametrize("length", [1, 2, 3, 4, 7, 16])
def test_device_fold_sweeps_equal_to_host_and_jax_folds(length):
    rng = np.random.default_rng(length)
    for _ in range(8):
        toks = rng.integers(0, 2**31 - 1, length).tolist()
        want = mix_fold_int(toks)
        assert _device_fold(toks) == want == _jax_fold(toks), toks


def test_vectorized_device_fold_matches_host():
    # a batch of hashes folded at once: every lane is its own chain
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 2**31 - 1, (64, 5))
    h = torch.full((64,), MIX_SEED, dtype=torch.int64)
    for j in range(5):
        h = mix_step(h, torch.from_numpy(toks[:, j]))
    assert [int(v) for v in h] == [mix_fold_int(row) for row in toks.tolist()]
    assert mix_fold_int([]) == MIX_SEED and mix_fold_int([1, 2]) != mix_fold_int([2, 1])


# --------------------------------------------------------------- perplexity


def _logprobs(n, seed):
    return -np.random.default_rng(seed).uniform(0.01, 3.0, n).astype(np.float32)


@pytest.mark.parametrize("bucketed", [False, True])
def test_streaming_perplexity_step_by_step_equals_jax_and_whole_sequence(bucketed):
    lp = _logprobs(37, 2)
    port, whole, jax_m = T.StreamingPerplexity(device=CPU), T.StreamingPerplexity(device=CPU), J.StreamingPerplexity()
    with config.shape_bucketing(bucketed):
        for v in lp:
            port.update(float(v))
        for chunk in np.array_split(lp, 5):
            whole.update(torch.from_numpy(chunk))
    for v in lp:
        jax_m.update(float(v))
    assert _np(port.compute()).tobytes() == np.asarray(jax_m.compute()).tobytes()
    assert _np(whole.compute()).tobytes() == _np(port.compute()).tobytes()
    _assert_same_states(port, jax_m)


# ---------------------------------------------------------------- token edit


def _edit_steps(n, seed, vocab=9):
    rng = np.random.default_rng(seed)
    hyp = rng.integers(0, vocab, n).astype(np.int32)
    ref = rng.integers(0, vocab, n).astype(np.int32)
    hyp[rng.random(n) < 0.15] = -1
    ref[rng.random(n) < 0.15] = -1
    return hyp, ref


@pytest.mark.parametrize("cls", ["StreamingTokenAccuracy", "StreamingTokenEditStats"])
@pytest.mark.parametrize("bucketed", [False, True])
def test_token_edit_metrics_equal_jax(cls, bucketed):
    hyp, ref = _edit_steps(50, 4)
    port, jax_m = getattr(T, cls)(device=CPU), getattr(J, cls)()
    with config.shape_bucketing(bucketed):
        for chunk_h, chunk_r in zip(np.array_split(hyp, 7), np.array_split(ref, 7)):
            port.update(chunk_h, chunk_r)
    for h, r in zip(hyp, ref):
        jax_m.update(int(h), int(r))
    got, want = port.compute(), jax_m.compute()
    if cls == "StreamingTokenEditStats":
        for g, w in zip(got, want):
            assert _np(g).tobytes() == np.asarray(w).tobytes()
    else:
        assert _np(got).tobytes() == np.asarray(want).tobytes()
    _assert_same_states(port, jax_m)


def test_token_edit_none_reference_and_misaligned_rows():
    m = T.StreamingTokenEditStats(device=CPU)
    m.update([1, 2, 3])
    assert int(m.insertions) == 3 and int(m.num_ref_tokens) == 0
    assert float(m.compute().error_rate) == 0.0
    with pytest.raises(ValueError, match="align"):
        m.update([1, 2], [1])


# --------------------------------------------------------------------- ngram


def _ngram_pairs(seed, n_seq=4):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_seq):
        length = int(rng.integers(3, 14))
        hyp = rng.integers(0, 6, length).astype(np.int32)
        ref = hyp.copy()
        ref[rng.random(length) < 0.3] = rng.integers(0, 6)
        cut = int(rng.integers(0, 3))
        if cut:
            ref[-cut:] = -1
        out.append((hyp, ref))
    return out


# the overlap and brevity penalty go through log/exp, whose float32
# implementations differ by an ulp between XLA and torch: rtol 1e-6 there;
# every integer field bitwise
OVERLAP_RTOL = 1e-6


def _assert_overlap_equal(got, want):
    for name, g, w in zip(type(got)._fields, got, want):
        g, w = _np(g), np.asarray(w)
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=OVERLAP_RTOL, atol=0, err_msg=name)
        else:
            assert g.tobytes() == w.tobytes() and g.dtype == w.dtype, name


@pytest.mark.parametrize("n_gram,buckets", [(1, 8), (2, 16), (4, 128)])
@pytest.mark.parametrize("bucketed", [False, True])
def test_ngram_overlap_equals_jax(n_gram, buckets, bucketed):
    port = T.StreamingNgramOverlap(n_gram=n_gram, buckets=buckets, device=CPU)
    whole = T.StreamingNgramOverlap(n_gram=n_gram, buckets=buckets, device=CPU)
    jax_m = J.StreamingNgramOverlap(n_gram=n_gram, buckets=buckets)
    for hyp, ref in _ngram_pairs(n_gram + buckets):
        with config.shape_bucketing(bucketed):
            for h, r in zip(hyp, ref):
                port.update(int(h), int(r))
            whole.update(hyp, ref)
        for h, r in zip(hyp, ref):
            jax_m.update(int(h), int(r))
        _assert_same_states(port, jax_m)  # in-flight planes and tails too
        port.finish()
        whole.finish()
        jax_m.finish()
    got, want = port.compute(), jax_m.compute()
    _assert_overlap_equal(got, want)
    for g, w in zip(whole.compute(), got):
        assert _np(g).tobytes() == _np(w).tobytes()
    _assert_same_states(port, jax_m)


def test_ngram_idle_finish_is_a_noop_and_validation():
    m = T.StreamingNgramOverlap(n_gram=2, device=CPU)
    m.finish()
    assert int(m.num_sequences) == 0
    with pytest.raises(ValueError, match="n_gram"):
        T.StreamingNgramOverlap(n_gram=0, device=CPU)
    with pytest.raises(ValueError, match="power of two"):
        T.StreamingNgramOverlap(buckets=12, device=CPU)


# ------------------------------------------------------- merges, cross-loads


@pytest.mark.parametrize("cls", ["StreamingPerplexity", "StreamingTokenEditStats", "StreamingNgramOverlap"])
def test_state_dicts_cross_load_both_ways_and_merge(cls):
    hyp, ref = _edit_steps(20, 9, vocab=5)
    lp = _logprobs(20, 9)
    jax_m, port = getattr(J, cls)(), getattr(T, cls)(device=CPU)

    def feed(m, lo, hi):
        for i in range(lo, hi):
            if cls == "StreamingPerplexity":
                m.update(float(lp[i]))
            else:
                m.update(int(max(hyp[i], 0)), int(max(ref[i], 0)))

    feed(jax_m, 0, 12)
    load_numpy_state_dict(port, _jax_sd(jax_m))
    _assert_same_states(port, jax_m)
    feed(port, 12, 20)
    feed(jax_m, 12, 20)
    back = getattr(J, cls)()
    back.load_state_dict({k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                          for k, v in numpy_state_dict(port).items()})
    _assert_same_states(port, back)
    # a SUM merge of two halves equals the single stream for the counters
    if cls != "StreamingPerplexity":
        a, b = getattr(T, cls)(device=CPU), getattr(T, cls)(device=CPU)
        feed(a, 0, 12)
        if cls == "StreamingNgramOverlap":
            a.finish()
        feed(b, 12, 20)
        a.merge_state([b])
        one = getattr(T, cls)(device=CPU)
        feed(one, 0, 12)
        if cls == "StreamingNgramOverlap":
            one.finish()
        feed(one, 12, 20)
        for k, v in one.state_dict().items():
            assert torch.equal(getattr(a, k), v), k


def test_streaming_table_is_lazy_and_doctests_run():
    assert T.StreamTable.__name__ == "StreamTable"
    with pytest.raises(AttributeError):
        T.NotAThing  # noqa: B018
    for module in ("perplexity", "edit", "ngram"):
        result = doctest.testmod(importlib.import_module(f"torcheval_tpu_torch.streaming.{module}"))
        assert result.failed == 0 and result.attempted > 0, module
