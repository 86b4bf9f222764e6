"""The plain reference against float64 NumPy written out here, at small
sizes, and its GPT-2 equations against the program's ``TransformerLM`` in
float32."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from evalbench import traffic as gen
from evalbench.reference import compare, ctr, gpt2


def _data(n=5000, seed=0, ties=False):
    rng = np.random.default_rng(seed)
    s = 1 / (1 + np.exp(-(rng.normal(-2.0, 1.5, n))))
    if ties:
        s = np.clip(np.round(s, 2), 0.01, 0.99)
    y = (rng.random(n) < s).astype(np.float64)
    return s.astype(np.float32).astype(np.float64), y


def _np_curves(keys, y):
    """AUROC (pairs: a positive above a negative counts 1, a tie 1/2) and
    average precision, by loops over the distinct keys."""
    pos, neg = y == 1, y == 0
    diff = keys[pos][:, None] - keys[neg][None, :]
    auroc = ((diff > 0).sum() + 0.5 * (diff == 0).sum()) / (pos.sum() * neg.sum())
    ap, tp, fp = 0.0, 0.0, 0.0
    for k in np.unique(keys)[::-1]:
        at = keys == k
        dtp = y[at].sum()
        tp += dtp
        fp += (1 - y[at]).sum()
        ap += dtp / pos.sum() * tp / (tp + fp)
    return auroc, ap


def _values(panel_kinds, s, y, batch=777, **args):
    panel = [{"name": k, "reference": k, "args": args} for k in panel_kinds]
    return ctr.panel_values(panel, torch.from_numpy(s).float(), torch.from_numpy(y).float(), batch)


@pytest.mark.parametrize("ties", (False, True))
def test_counts_and_exact_curves(ties):
    s, y = _data(ties=ties)
    got = _values(["ne", "ctr", "calibration", "exact_auroc", "exact_auprc"], s, y)
    p = y.mean()
    ce = -(y * np.log(s) + (1 - y) * np.log1p(-s)).mean()
    want_ne = ce / -(p * np.log(p) + (1 - p) * np.log(1 - p))
    auroc, ap = _np_curves(s, y)
    np.testing.assert_allclose(got["ne"], want_ne, rtol=1e-12)
    np.testing.assert_allclose(got["ctr"], p, rtol=1e-12)
    np.testing.assert_allclose(got["calibration"], s.sum() / y.sum(), rtol=1e-12)
    np.testing.assert_allclose(got["exact_auroc"], auroc, rtol=1e-12)
    np.testing.assert_allclose(got["exact_auprc"], ap, rtol=1e-12)


def test_binned_curves_are_exact_curves_over_bin_index():
    s, y = _data(seed=1)
    bins = 64
    got = _values(["binned_auroc", "binned_auprc"], s, y, num_bins=bins)
    idx = np.minimum(np.floor(s * bins), bins - 1)
    auroc, ap = _np_curves(idx, y)
    np.testing.assert_allclose(got["binned_auroc"], auroc, rtol=1e-12)
    np.testing.assert_allclose(got["binned_auprc"], ap, rtol=1e-12)


def test_bfloat16_panel_is_the_control():
    s, y = _data(n=50_000, seed=2)
    panel = [{"name": k, "reference": k, "args": {"num_bins": 256}}
             for k in ("ne", "ctr", "binned_auroc")]
    s_t, y_t = torch.from_numpy(s).float(), torch.from_numpy(y).float()
    want = ctr.panel_values(panel, s_t, y_t, 4096)
    low = ctr.panel_values(panel, s_t, y_t, 4096, dtype=torch.bfloat16)
    assert max(compare.panel_readings([low], want).values()) > 1e-3


def test_token_nll_and_hits_against_numpy():
    g = torch.Generator().manual_seed(3)
    logits = torch.randn(300, 50, generator=g)
    targets = torch.randint(0, 50, (300,), generator=g)
    z = logits.double().numpy()
    lse = np.log(np.exp(z - z.max(1, keepdims=True)).sum(1)) + z.max(1)
    nll = lse - z[np.arange(300), targets.numpy()]
    np.testing.assert_allclose(compare._token_nll(logits, targets, rows=64).numpy(), nll, rtol=1e-12)
    assert compare._argmax_hits(logits, targets, rows=64) == int((z.argmax(1) == targets.numpy()).sum())
    ppl = np.exp(nll.mean())
    assert compare.perplexity_value_rel(float(ppl), float(nll.sum()), 300) < 1e-12


def test_step_readings_of_a_faithful_step_are_zero():
    g = torch.Generator().manual_seed(4)
    logits = torch.randn(64, 40, generator=g)
    targets = torch.randint(0, 40, (64,), generator=g)
    nll = float(compare._token_nll(logits, targets).sum())
    delta = {"sum_log_probs": nll, "ppl_count": 64, "acc_count": 64,
             "acc_correct": compare._argmax_hits(logits, targets)}
    r = compare.step_readings(logits, delta, logits, targets)
    assert r == {"logit_rms_rel": 0.0, "token_nll_gap_max": 0.0, "nll_sum_gap": 0.0, "count_gap": 0}


def test_nll_sum_gap_holds_a_bfloat16_step_sum_and_fails_a_bias():
    """A step's NLL sum kept in bfloat16 (8,192 tokens of ~10.8 nats: a
    step of 512) sits within half a step, 0.031 nats a token, of its
    float64 value, under the cell's limit; a bias of 0.09 nats a token does
    not, wherever the rounding falls."""
    from evalbench import spec

    limit = spec.cell("gpt2xl_eval").limits["nll_sum_gap"]
    for seed in range(6):
        g = torch.Generator().manual_seed(seed)
        logits = torch.randn(8192, 50, generator=g) * 0.3
        targets = torch.randint(0, 50, (8192,), generator=g)
        logits[torch.arange(8192), targets] -= 7.0  # ~10.8 nats a token
        nll = float(compare._token_nll(logits, targets).sum())
        delta = {"ppl_count": 8192, "acc_count": 8192,
                 "acc_correct": compare._argmax_hits(logits, targets)}
        for bias in (0.0, 0.09):
            held = float(torch.tensor(nll + 8192 * bias).to(torch.bfloat16))
            r = compare.step_readings(logits, dict(delta, sum_log_probs=held), logits, targets)
            assert abs(r["nll_sum_gap"] - bias) <= 256 / 8192
            assert (r["nll_sum_gap"] <= limit) == (bias == 0.0), (seed, bias, r)


def _tiny_config():
    return {"vocab_size": 97, "n_positions": 16, "n_embd": 32, "n_head": 4, "n_layer": 2,
            "n_inner": None, "layer_norm_epsilon": 1e-6, "initializer_range": 0.2}


def test_gpt2_equations_match_transformer_lm_in_float32():
    from torcheval_tpu_torch.models import TransformerLM

    cfg = _tiny_config()
    weights = gen.lm_weights(cfg, 5, "cpu", dtype=torch.float32)
    with torch.no_grad():
        for k, v in weights.items():
            if k.endswith(".scale") or k.endswith(".bias"):
                v.normal_(0.0 if k.endswith(".bias") else 1.0, 0.1)
        model = TransformerLM(vocab_size=97, d_model=32, n_heads=4, n_layers=2, d_ff=128,
                              max_len=16, device="cpu", dtype=torch.float32)
        model.load_state_dict(weights)
        tokens = torch.randint(0, 97, (3, 16), generator=torch.Generator().manual_seed(6))
        want = model(tokens)
        got = gpt2.forward(weights, tokens, cfg)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_fp8_control_moves_the_logits():
    cfg = _tiny_config()
    weights = gen.lm_weights(cfg, 7, "cpu")
    tokens = torch.randint(0, 97, (2, 16), generator=torch.Generator().manual_seed(8))
    with torch.no_grad():
        ref = gpt2.forward(weights, tokens, cfg)
        low = gpt2.forward(weights, tokens, cfg, fp8_control=True)
    assert low.dtype == torch.bfloat16
    rms = float((low.double() - ref.double()).pow(2).mean().sqrt() / ref.double().pow(2).mean().sqrt())
    assert rms > 0.02
