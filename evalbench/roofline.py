"""Peaks of the card and the work each roofline counts.

Every count is of the work the inputs need, whatever implements it: each
input byte read once, each output byte written once, and for a model the
multiply-adds its equations need (2 FLOPs each). A roofline share is the
least time the card could take for that work over the time measured, in
percent; it cannot pass 100 unless a count is too high or the time leaves
out part of the work.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import Optional

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit
BF16_PEAK_FLOPS = 989.4e12
HBM_BYTES_PER_S = 3.35e12


def power_limit_w() -> Optional[float]:
    """The card's power limit in watts (``nvidia-smi``), or None where it
    cannot be read. A card below 700 W runs slower than the peaks above."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    try:
        out = subprocess.run([smi, "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (subprocess.SubprocessError, ValueError, IndexError, OSError):
        return None


def k1_bytes(n: int, num_bins: int, tasks: int = 1, weighted: bool = False) -> int:
    """One K1 launch over ``n`` samples a task (``chip_smoke.py``'s
    ``bound_ms``): scores and labels (and weights) read once as float32,
    the (tasks, 2, num_bins) float32 histogram read and written once."""
    return (12 if weighted else 8) * tasks * n + 2 * 8 * tasks * num_bins


def curve_bytes(n: int, metrics: int) -> int:
    """A pass-end exact curve compute over ``n`` buffered samples in each
    of ``metrics`` metrics: each metric's float32 scores and labels read
    once."""
    return 8 * n * metrics


def bridge_bytes(tokens: int, vocab: int, logit_bytes: int = 2, target_bytes: int = 8) -> int:
    """The metric updates over one step's logits: the (tokens, vocab)
    logits read once (both metrics need no more than one read) and the
    targets once."""
    return tokens * vocab * logit_bytes + tokens * target_bytes


def lm_forward_flops(vocab: int, d_model: int, d_ff: int, n_layers: int, seq: int,
                     batch: int = 1, causal: bool = True) -> int:
    """FLOPs of one ``TransformerLM`` forward over ``batch`` windows of
    ``seq`` tokens: every matmul (q, k, v, out, the MLP's two and the
    head, 2 m n k each) and attention's two products. Causal attention
    needs half the S x S products: 2 S d a token a layer (QK^T and PV
    over the S / 2 keys it sees on average); ``causal=False`` counts the
    full S x S, as dense code materialises it."""
    tokens = batch * seq
    matmul = 2 * tokens * (n_layers * (4 * d_model * d_model + 2 * d_model * d_ff) + d_model * vocab)
    attention = n_layers * batch * seq * seq * d_model * (2 if causal else 4)
    return matmul + attention


def share_pct(least_s: float, measured_s: float) -> Optional[float]:
    """``least_s / measured_s`` in percent, or None when nothing was
    measured."""
    if not measured_s or measured_s <= 0:
        return None
    return 100.0 * least_s / measured_s
