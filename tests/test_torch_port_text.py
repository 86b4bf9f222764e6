"""torcheval_tpu_torch's text family -- perplexity, BLEU, word error
rate, word information lost and preserved -- against the JAX package on
the same numpy inputs: functional forms over their edge cases, and the
classes through update, compute, reset, ``merge_state``, a ``state_dict``
cross-load both ways, ``MetricClassTester`` and a ``LocalReplicaGroup``
sync.

Tolerances:

- perplexity, float32 logits: the NLL sum and the perplexity within rtol
  1e-6 (the JAX package's CPU path is a native kernel with a sequential
  float32 exp sum; torch's ``log_softmax`` sums in another order). At the
  Llama-3 vocabulary (128,256) and perplexities of 5 to 200 the measured
  gap was at most 1.5e-7 on the sum and 5.2e-7 on the perplexity; the
  token count is bitwise.
- perplexity, bfloat16/float16 logits: the port runs
  ``jax.nn.log_softmax``'s op sequence, rounding to the input dtype after
  each op as XLA does. At V = 128,256 the bfloat16 batch sums were bitwise
  equal to the JAX package's in 18 of 18 cases and the perplexity within
  1.02e-7; the tests hold the sum bitwise and the perplexity within rtol
  2.4e-7 (two float32 ulps of the final exp, whose implementations
  differ).
- BLEU: every counter bitwise; the score within rtol 1e-6 (log, exp and a
  weighted sum of up to four terms in float32).
- WER, WIL and WIP: counts and rates bitwise (float32 quotients of exact
  counts, NaN before any update).
"""

from __future__ import annotations

import doctest
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as JM
import torcheval_tpu.metrics.functional as JF
from torcheval_tpu import distributed as jdist
from torcheval_tpu.metrics import toolkit as jtoolkit
import torcheval_tpu_torch.metrics as TM
import torcheval_tpu_torch.metrics.functional as TF
from torcheval_tpu_torch import distributed as tdist
from torcheval_tpu_torch.metrics import toolkit as ttoolkit
from torcheval_tpu_torch.utils import load_numpy_state_dict, numpy_state_dict
from torcheval_tpu_torch.utils.test_utils import MetricClassTester

CPU = "cpu"
RTOL = 1e-6
HALF_RTOL = 2.4e-7
LLAMA3_VOCAB = 128_256


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _same(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, got.dtype,
                                                                  want.shape, want.dtype)
    assert got.tobytes() == want.tobytes(), (got, want)


def _close(got, want, rtol=RTOL):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0, equal_nan=True)


# ------------------------------------------------------------ perplexity


def _lm_batch(seed, shape, vocab, margin=10.0, scale=1.0):
    """N(0, scale) logits with ``margin`` added at each target; targets
    include -1, -vocab - 3, vocab and vocab + 7 (clipped by the JAX
    package's gather) and -100 (Hugging Face's ignore index)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((*shape, vocab)) * scale).astype(np.float32)
    t = rng.integers(0, vocab, shape)
    np.put_along_axis(x, t[..., None], np.take_along_axis(x, t[..., None], -1) + margin, -1)
    planted = [-100, -1, vocab + 7, vocab, -vocab - 3][:t.size]
    t.reshape(-1)[:len(planted)] = planted
    return x, t


def _as(x, dtype):
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("ignore_index", [None, 3, -100], ids=["none", "in_range", "hf"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["f32", "bf16", "f16"])
def test_perplexity_matches_jax(dtype, ignore_index):
    x, t = _lm_batch(1, (3, 17), 40, margin=2.0)
    t[1, :4] = 3
    xt = _as(x, dtype)
    got = TF.perplexity(xt, t, ignore_index, device=CPU)
    want = JF.perplexity(xt, t, ignore_index)
    _close(got, want, RTOL if dtype == torch.float32 else HALF_RTOL)
    tm = TM.Perplexity(ignore_index=ignore_index, device=CPU).update(xt, t)
    jm = JM.Perplexity(ignore_index=ignore_index).update(xt, t)
    _same(tm.num_total, jm.num_total)
    if dtype == torch.float32:
        _close(tm.sum_log_probs, jm.sum_log_probs)
    else:
        _same(tm.sum_log_probs, jm.sum_log_probs)
    assert int(tm.num_total) == (t != ignore_index).sum()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_perplexity_at_llama3_vocab_matches_jax(seed, dtype):
    """The gap the tolerances above state, at the Llama-3 vocabulary."""
    x, t = _lm_batch(seed, (2, 24), LLAMA3_VOCAB, margin=(10.0, 3.0, 6.0)[seed],
                     scale=(1.0, 0.5, 2.0)[seed])
    xt = _as(x, dtype)
    for ignore_index in (None, -100):
        tm = TM.Perplexity(ignore_index=ignore_index, device=CPU).update(xt, t)
        jm = JM.Perplexity(ignore_index=ignore_index).update(xt, t)
        _same(tm.num_total, jm.num_total)
        if dtype == torch.float32:
            _close(tm.sum_log_probs, jm.sum_log_probs)
            _close(tm.compute(), jm.compute())
        else:
            _same(tm.sum_log_probs, jm.sum_log_probs)
            _close(tm.compute(), jm.compute(), HALF_RTOL)
        _close(TF.perplexity(xt, t, ignore_index, device=CPU),
               JF.perplexity(xt, t, ignore_index),
               RTOL if dtype == torch.float32 else HALF_RTOL)


def test_half_precision_batch_sum_stays_in_the_input_dtype():
    """The functional sum of a bfloat16 batch is a bfloat16 scalar, as in
    JAX; the perplexity is float32; the class state stays float32."""
    from torcheval_tpu_torch.metrics.functional.text.perplexity import _perplexity_update_jit

    x, t = _lm_batch(4, (2, 9), 30)
    total, count = _perplexity_update_jit(_as(x, torch.bfloat16), torch.from_numpy(t), None)
    assert total.dtype == torch.bfloat16 and count.dtype == torch.int32
    assert TF.perplexity(_as(x, torch.bfloat16), t, device=CPU).dtype == torch.float32
    m = TM.Perplexity(device=CPU).update(_as(x, torch.bfloat16), t)
    assert m.sum_log_probs.dtype == torch.float32 and m.num_total.dtype == torch.int32


@pytest.mark.parametrize("target", [-1, -2, -100, -40, -41, -1000, 40, 47, 1 << 20, 0, 39])
def test_out_of_range_targets_read_what_jax_reads(target):
    """``take_along_axis(mode="clip")``: a negative target wraps once from
    the end, then every index clamps into [0, V-1]."""
    x, _ = _lm_batch(5, (1, 3), 40)
    t = np.array([[target, 7, target]])
    # the planted margins sit elsewhere: a perplexity near 1e5, where exp
    # turns the sums' 1e-7 gap into 2e-6, so the sums are compared
    _close(TM.Perplexity(device=CPU).update(x, t).sum_log_probs,
           JM.Perplexity().update(x, t).sum_log_probs)
    x64 = x[0].astype(np.float64)
    lse = np.log(np.exp(x64 - x64.max(-1, keepdims=True)).sum(-1)) + x64.max(-1)
    index = min(max(target + 40 if target < 0 else target, 0), 39)
    want = lse[0] - x64[0, index]
    got = TM.Perplexity(device=CPU).update(x[:, :1], t[:, :1]).sum_log_probs
    assert abs(float(got) - want) <= 1e-5 * want


def test_out_of_range_targets_never_reach_gather(monkeypatch):
    """Every index handed to ``torch.gather`` lies in range."""
    real = torch.gather
    seen = []

    def checked(input, dim, index, *a, **kw):
        seen.append(index)
        assert bool(((index >= 0) & (index < input.shape[dim])).all()), index
        return real(input, dim, index, *a, **kw)

    monkeypatch.setattr(torch, "gather", checked)
    x, t = _lm_batch(6, (2, 11), 25)
    t[1, :4] = [-(1 << 30), (1 << 30), -26, 25]
    for ignore_index in (None, -100):
        _close(TF.perplexity(x, t, ignore_index, device=CPU), JF.perplexity(x, t, ignore_index))
    assert len(seen) == 2


def test_int64_targets_narrow_like_jax():
    """64-bit targets arrive in the JAX package as int32 (x64 off)."""
    x, t = _lm_batch(7, (1, 6), 20)
    t[0, 5] = (1 << 32) + 3  # reads class 3 after the narrowing
    _close(TF.perplexity(torch.from_numpy(x), torch.from_numpy(t), device=CPU),
           JF.perplexity(torch.from_numpy(x), torch.from_numpy(t)))


@pytest.mark.parametrize("shapes", [((2, 3), (2, 3)), ((2, 3, 4), (2, 3, 1)),
                                    ((2, 3, 4), (3, 3)), ((2, 3, 4), (2, 4))])
def test_perplexity_shape_checks_match_jax(shapes):
    x = np.zeros(shapes[0], np.float32)
    t = np.zeros(shapes[1], np.int64)
    with pytest.raises(ValueError) as theirs:
        JF.perplexity(x, t)
    with pytest.raises(ValueError) as ours:
        TF.perplexity(x, t, device=CPU)
    assert str(ours.value).split("got")[0] == str(theirs.value).split("got")[0]


def test_update_collection_runs_the_perplexity_plan():
    x, t = _lm_batch(8, (2, 13), 30)
    coll = {"ppl": TM.Perplexity(device=CPU), "ppl_ignore": TM.Perplexity(ignore_index=-100,
                                                                          device=CPU)}
    ttoolkit.update_collection(coll, x, t)
    jcoll = {"ppl": JM.Perplexity(), "ppl_ignore": JM.Perplexity(ignore_index=-100)}
    jtoolkit.update_collection(jcoll, x, t)
    for name in coll:
        _same(coll[name].num_total, jcoll[name].num_total)
        _close(coll[name].compute(), jcoll[name].compute())


# -------------------------------------------------------------- sentences


def _sentences(seed, n, vocab=60, lo=1, hi=14, sub=0.3, dele=0.1, refs=1):
    """Seeded sentences over a Zipfian vocabulary and, for each, ``refs``
    references made from it by substitutions and deletions."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    words = np.array([f"w{i}" for i in range(vocab)])
    cands, targets = [], []
    for _ in range(n):
        ref = words[rng.choice(vocab, rng.integers(lo, hi + 1), p=p)]
        cands_refs = []
        for _ in range(refs):
            keep = rng.random(ref.size) >= dele
            out = np.where(rng.random(ref.size) < sub, words[rng.choice(vocab, ref.size, p=p)], ref)
            cands_refs.append(" ".join(out[keep]))
        cands.append(" ".join(ref))
        targets.append(cands_refs)
    return cands, targets


# ------------------------------------------------------------------ BLEU


@pytest.mark.parametrize("weights", [None, "custom"])
@pytest.mark.parametrize("refs", [1, 3])
@pytest.mark.parametrize("n_gram", [1, 2, 3, 4])
def test_bleu_matches_jax(n_gram, refs, weights):
    cands, targets = _sentences(n_gram * 10 + refs, 40, lo=n_gram, refs=refs)
    if weights == "custom":
        weights = np.linspace(1.0, 2.0, n_gram).astype(np.float32)
        weights /= weights.sum()
    _close(TF.bleu_score(cands, targets, n_gram, weights, device=CPU),
           JF.bleu_score(cands, targets, n_gram, weights))
    tm = TM.BLEUScore(n_gram=n_gram, weights=weights, device=CPU)
    jm = JM.BLEUScore(n_gram=n_gram, weights=weights)
    for lo in range(0, 40, 16):
        tm.update(cands[lo:lo + 16], targets[lo:lo + 16])
        jm.update(cands[lo:lo + 16], targets[lo:lo + 16])
    _assert_states(tm, jm)
    _close(tm.compute(), jm.compute())


def test_bleu_one_string_and_string_references():
    for cand, ref in (("the cat sat on the mat", ["the cat sat on a mat"]),
                      ("a b c d e", ["a b c d e f g"]),  # shorter: brevity penalty
                      ("a b c d e f g", ["a b c d e"])):  # longer: none
        _close(TF.bleu_score(cand, ref, device=CPU), JF.bleu_score(cand, ref))
        _close(TF.bleu_score(cand, [ref], n_gram=2, device=CPU), JF.bleu_score(cand, [ref], n_gram=2))


def test_bleu_brevity_penalty_is_one_only_for_longer_candidates():
    """Equal lengths take ``exp(1 - r/c)`` (= 1); a candidate one word
    shorter is penalized, one word longer is not."""
    ref = ["a b c d e f"]
    for cand in ("a b c d e f", "a b c d e", "a b c d e f g"):
        _close(TF.bleu_score(cand, ref, n_gram=1, device=CPU), JF.bleu_score(cand, ref, n_gram=1))
    short = float(TF.bleu_score("a b c d e", ref, n_gram=1, device=CPU))
    assert abs(short - np.exp(1 - 6 / 5)) < 1e-6


@pytest.mark.parametrize("call", [
    lambda F, **k: F.bleu_score(["a b"], [["a b"], ["c"]], **k),
    lambda F, **k: F.bleu_score(["a b"], [["a b"]], n_gram=3, **k),
    lambda F, **k: F.bleu_score(["a b c"], [["a b c"]], n_gram=5, **k),
    lambda F, **k: F.bleu_score(["a b c"], [["a b c"]], n_gram=2, weights=[0.5], **k),
])
def test_bleu_bad_arguments_raise_like_jax(call):
    with pytest.raises(ValueError) as theirs:
        call(JF)
    with pytest.raises(ValueError) as ours:
        call(TF, device=CPU)
    assert str(ours.value).split("got")[0] == str(theirs.value).split("got")[0]
    for P, kw in ((JM, {}), (TM, {"device": CPU})):
        with pytest.raises(ValueError):
            P.BLEUScore(n_gram=5, **kw)
        with pytest.raises(ValueError):
            P.BLEUScore(n_gram=2, weights=[1.0], **kw)


def test_bleu_is_zero_before_any_match():
    for P, kw in ((JM, {}), (TM, {"device": CPU})):
        m = P.BLEUScore(n_gram=2, **kw)
        assert float(m.compute()) == 0.0
        m.update(["x y z"], [["a b c"]])
        assert float(m.compute()) == 0.0
    assert TM.BLEUScore(n_gram=2, device=CPU).compute().dtype == torch.float32


# --------------------------------------------------------- WER, WIL, WIP


_WORD = {
    "wer": (TF.word_error_rate, JF.word_error_rate),
    "wil": (TF.word_information_lost, JF.word_information_lost),
    "wip": (TF.word_information_preserved, JF.word_information_preserved),
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(_WORD))
def test_word_rates_match_jax_bitwise(name, seed):
    ours, theirs = _WORD[name]
    cands, targets = _sentences(100 + seed, 50, lo=0, hi=20, sub=0.2 + 0.2 * seed)
    targets = [t[0] for t in targets]
    cands[3], targets[4] = "", ""  # an empty hypothesis and an empty reference
    _same(ours(cands, targets, device=CPU), theirs(cands, targets))
    _same(ours(cands[0], targets[0], device=CPU), theirs(cands[0], targets[0]))


@pytest.mark.parametrize("name", sorted(_WORD))
def test_word_rates_of_empty_text_are_nan_like_jax(name):
    ours, theirs = _WORD[name]
    for a, b in (([], []), ("", ""), ([""], [""]), (["a b"], [""])):
        _same(ours(a, b, device=CPU), theirs(a, b))


@pytest.mark.parametrize("name", sorted(_WORD))
def test_word_rate_checks_match_jax(name):
    ours, theirs = _WORD[name]
    for a, b in (("a", ["a"]), (["a", "b"], ["a"])):
        with pytest.raises(ValueError) as j:
            theirs(a, b)
        with pytest.raises(ValueError) as t:
            ours(a, b, device=CPU)
        assert str(t.value).split("got")[0] == str(j.value).split("got")[0]


def test_edit_distance_matches_a_python_dp():
    from torcheval_tpu_torch.metrics.functional.text.helper import _edit_distance

    def dp(a, b):
        prev = list(range(len(b) + 1))
        for i, x in enumerate(a, 1):
            cur = [i]
            for j, y in enumerate(b, 1):
                cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (x != y)))
            prev = cur
        return prev[-1]

    cands, targets = _sentences(7, 200, vocab=8, lo=0, hi=12, sub=0.4, dele=0.3)
    for c, (t,) in zip(cands, targets):
        assert _edit_distance(c.split(), t.split()) == dp(c.split(), t.split())


# --------------------------------------------------------------- classes


def _text_batches(seed, n_batches=3):
    out = []
    for i in range(n_batches):
        c, t = _sentences(seed + i, 12, lo=4, hi=16)
        out.append((c, [r[0] for r in t]))
    return out


def _ppl_batches(seed, dtype=torch.float32, n_batches=3):
    out = []
    for i in range(n_batches):
        x, t = _lm_batch(seed + i, (2, 9), 30)
        out.append((_as(x, dtype), t))
    return out


def _bleu_batches(seed, n_batches=3):
    out = []
    for i in range(n_batches):
        c, t = _sentences(seed + i, 10, lo=4, hi=16, refs=2)
        out.append((c, t))
    return out


# name -> (constructor given the package and device kwargs, batch maker)
CASES = {
    "ppl": (lambda P, **k: P.Perplexity(**k), _ppl_batches),
    "ppl_ignore": (lambda P, **k: P.Perplexity(ignore_index=-100, **k), _ppl_batches),
    "ppl_bf16": (lambda P, **k: P.Perplexity(ignore_index=-100, **k),
                 lambda s: _ppl_batches(s, torch.bfloat16)),
    "bleu": (lambda P, **k: P.BLEUScore(n_gram=4, **k), _bleu_batches),
    "bleu_weights": (lambda P, **k: P.BLEUScore(n_gram=3, weights=[0.5, 0.25, 0.25], **k),
                     _bleu_batches),
    "wer": (lambda P, **k: P.WordErrorRate(**k), _text_batches),
    "wil": (lambda P, **k: P.WordInformationLost(**k), _text_batches),
    "wip": (lambda P, **k: P.WordInformationPreserved(**k), _text_batches),
}
NAMES = sorted(CASES)
# float32 logits: the NLL sums reduce in another order
BITWISE = {n for n in NAMES if n not in ("ppl", "ppl_ignore")}


def _feed(metric, batches):
    for batch in batches:
        metric.update(*batch)
    return metric


def _assert_states(tm, jm, bitwise=True):
    ours, theirs = tm.state_dict(), jm.state_dict()
    assert sorted(ours) == sorted(theirs)
    for name in theirs:
        a, b = _np(ours[name]), np.asarray(theirs[name])
        if isinstance(theirs[name], float):
            assert isinstance(ours[name], float) and ours[name] == theirs[name], name
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, (name, a.dtype, b.dtype)
        if bitwise or a.dtype.kind in "iub":
            assert a.tobytes() == b.tobytes(), (name, a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, err_msg=name)


def _check(got, want, bitwise):
    (_same if bitwise else _close)(got, want)


@pytest.mark.parametrize("name", NAMES)
def test_class_update_compute_reset_matches_jax(name):
    make, batches = CASES[name]
    bitwise = name in BITWISE
    tm, jm = make(TM, device=CPU), make(JM)
    _assert_states(tm, jm)
    _feed(tm, batches(10))
    _feed(jm, batches(10))
    _assert_states(tm, jm, bitwise)
    compute_bitwise = bitwise and not name.startswith(("ppl", "bleu"))
    _check(tm.compute(), jm.compute(), compute_bitwise)
    _check(tm.compute(), jm.compute(), compute_bitwise)  # idempotent
    tm.reset()
    jm.reset()
    _assert_states(tm, jm)
    _feed(tm, batches(20)[:1])
    _feed(jm, batches(20)[:1])
    _check(tm.compute(), jm.compute(), compute_bitwise)


@pytest.mark.parametrize("name", ["wer", "wil", "wip"])
def test_word_rate_classes_are_nan_before_an_update_like_jax(name):
    make, _ = CASES[name]
    _same(make(TM, device=CPU).compute(), make(JM).compute())
    assert torch.isnan(make(TM, device=CPU).compute())


@pytest.mark.parametrize("name", NAMES)
def test_class_merge_then_compute_matches_jax(name):
    make, batches = CASES[name]
    stream = batches(30)
    tms = [_feed(make(TM, device=CPU), [b]) for b in stream]
    jms = [_feed(make(JM), [b]) for b in stream]
    tms[0].merge_state(tms[1:])
    jms[0].merge_state(jms[1:])
    _assert_states(tms[0], jms[0], name in BITWISE)
    _close(tms[0].compute(), jms[0].compute())


def _to_jax(sd):
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in sd.items()}


def _numpy_sd(jm):
    return {k: v if isinstance(v, (int, float)) else np.asarray(v)
            for k, v in jm.state_dict().items()}


@pytest.mark.parametrize("updated", [False, True], ids=["fresh", "updated"])
@pytest.mark.parametrize("name", NAMES)
def test_state_dict_cross_loads_both_ways(name, updated):
    make, batches = CASES[name]
    jm = _feed(make(JM), batches(40) if updated else [])
    tm = make(TM, device=CPU)
    load_numpy_state_dict(tm, _numpy_sd(jm))
    _assert_states(tm, jm)
    back = make(JM)
    back.load_state_dict(_to_jax(numpy_state_dict(tm)))
    _assert_states(tm, back)
    more = batches(50)[:2]
    _feed(tm, more)
    _feed(back, more)
    _assert_states(tm, back, name in BITWISE)
    _close(tm.compute(), back.compute())


def test_local_replica_sync_of_the_family_equals_jax():
    world = 3
    tgroup = tdist.LocalReplicaGroup([torch.device(CPU)] * world)
    jgroup = jdist.LocalReplicaGroup(jax.devices("cpu")[:world])
    treps = [{n: CASES[n][0](TM, device=CPU) for n in NAMES} for _ in range(world)]
    jreps = [{n: CASES[n][0](JM) for n in NAMES} for _ in range(world)]
    for n in NAMES:
        for r, batch in enumerate(CASES[n][1](60)):
            treps[r][n].update(*batch)
            jreps[r][n].update(*batch)
    tsynced = ttoolkit.get_synced_metric_collection(treps, tgroup)
    jsynced = jtoolkit.get_synced_metric_collection(jreps, jgroup)
    tvalues = ttoolkit.sync_and_compute_collection(treps, tgroup)
    for n in NAMES:
        _assert_states(tsynced[n], jsynced[n], n in BITWISE)
        _close(tsynced[n].compute(), jsynced[n].compute())
        _close(tvalues[n], jsynced[n].compute())


def _stream(name, n):
    """``n`` batches of ``name``'s inputs as ``update`` keyword lists."""
    batches = CASES[name][1](200 + NAMES.index(name)) + CASES[name][1](300 + NAMES.index(name))
    batches = (batches * n)[:n]
    return {"input": [b[0] for b in batches], "target": [b[1] for b in batches]}


class TestTextClasses(MetricClassTester):
    @pytest.mark.parametrize("name", NAMES)
    def test_class_contract(self, name):
        make, _ = CASES[name]
        kwargs = _stream(name, 8)

        def feed(m, indices):
            for i in indices:
                m.update(kwargs["input"][i], kwargs["target"][i])
            return m

        whole = np.asarray(feed(make(JM), range(8)).compute())
        ranks = [feed(make(JM), range(2 * r, 2 * r + 2)) for r in range(4)]
        ranks[0].merge_state(ranks[1:])
        self.run_class_implementation_tests(
            metric=make(TM, device=CPU),
            state_names=set(make(JM)._state_name_to_default),
            update_kwargs=kwargs,
            compute_result=whole,
            merge_and_compute_result=np.asarray(ranks[0].compute()),
            num_total_updates=8,
            num_processes=4,
            atol=1e-6,
            rtol=1e-6,
        )


def test_classes_move_between_devices_with_their_weights():
    m = TM.BLEUScore(n_gram=2, weights=[0.3, 0.7], device=CPU)
    assert m.to(CPU).weights.device == torch.device(CPU)
    assert TM.BLEUScore(n_gram=2, device=CPU).to(CPU).weights is None


@pytest.mark.parametrize("make", [
    lambda **k: TM.Perplexity(**k),
    lambda **k: TM.BLEUScore(n_gram=4, **k),
    lambda **k: TM.WordErrorRate(**k),
    lambda **k: TM.WordInformationLost(**k),
    lambda **k: TM.WordInformationPreserved(**k),
])
def test_classes_default_to_cuda(make):
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert make(device=CPU).device == torch.device(CPU)


@pytest.mark.parametrize("call", [
    lambda **k: TF.word_error_rate(["a"], ["a"], **k),
    lambda **k: TF.word_information_lost(["a"], ["a"], **k),
    lambda **k: TF.word_information_preserved(["a"], ["a"], **k),
    lambda **k: TF.bleu_score(["a b"], [["a b"]], n_gram=1, **k),
])
def test_string_functionals_default_to_cuda(call):
    if torch.cuda.is_available():
        assert call().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert call(device=CPU).device == torch.device(CPU)


_DOC_MODULES = [
    *[f"torcheval_tpu_torch.metrics.functional.text.{m}" for m in (
        "bleu", "perplexity", "word_error_rate", "word_information_lost",
        "word_information_preserved")],
    *[f"torcheval_tpu_torch.metrics.text.{m}" for m in (
        "bleu", "perplexity", "word_error_rate", "word_information_lost",
        "word_information_preserved")],
]


@pytest.mark.parametrize("module", _DOC_MODULES,
                         ids=lambda m: m.rsplit(".", 2)[-2] + "." + m.rsplit(".", 1)[-1])
def test_docstring_examples_run(module):
    result = doctest.testmod(importlib.import_module(module),
                             optionflags=doctest.NORMALIZE_WHITESPACE)
    assert result.attempted > 0 and result.failed == 0


def test_the_port_exports_the_text_family():
    for name in ("Perplexity", "BLEUScore", "WordErrorRate", "WordInformationLost",
                 "WordInformationPreserved"):
        assert name in TM.__all__ and name in JM.__all__
    for name in ("perplexity", "bleu_score", "word_error_rate", "word_information_lost",
                 "word_information_preserved"):
        assert name in TF.__all__ and name in JF.__all__
