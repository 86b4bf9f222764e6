"""The one generator of the benchmark's inputs.

A traffic file (``traffic/<name>.json``) and a configuration file hold
only parameters; this module turns them, with the run's seed, into the
tensors both the program and the reference are given. Everything is drawn
on the device with a ``torch.Generator`` seeded from ``--seed``, in a few
large calls: the same seed gives the same inputs, and the reference draws
them again from the seed rather than reading what the program was handed.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

_SEED_MASK = (1 << 63) - 1


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for ``seed``; ``stream`` separates the
    independent draws of one run (inputs, weights, samples)."""
    return torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + stream) & _SEED_MASK)


def click_eval_set(config: dict, seed: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A CTR eval set of ``config["samples"]`` rows: logits x ~ N(mean,
    std) (``score_logit_mean``, ``score_logit_std``), scores sigmoid(x) as
    float32, labels Bernoulli(score) as float32 0/1 (the skewed Criteo
    generator of ``chip_smoke.py``)."""
    g = generator(seed, device)
    n = int(config["samples"])
    x = torch.randn(n, generator=g, device=device)
    x.mul_(float(config["score_logit_std"])).add_(float(config["score_logit_mean"]))
    scores = torch.sigmoid(x)
    del x
    labels = (torch.rand(n, generator=g, device=device) < scores).to(torch.float32)
    return scores, labels


def batches(n: int, batch: int):
    """``(start, stop)`` of each batch of a pass: full batches, then the
    ragged tail."""
    return [(a, min(a + batch, n)) for a in range(0, n, batch)]


def token_pool(config: dict, traffic: dict, seed: int, device) -> torch.Tensor:
    """``pool_steps`` steps of ``windows_per_step`` windows of ``window +
    1`` ids, uniform over the vocabulary: (steps, windows, window + 1)
    int64. Step k of a run reads entry k mod pool_steps; a window's inputs
    are ids[:-1] and its targets ids[1:]."""
    g = generator(seed, device, stream=1)
    shape = (int(traffic["pool_steps"]), int(traffic["windows_per_step"]), int(traffic["window"]) + 1)
    return torch.randint(0, int(config["vocab_size"]), shape, generator=g, device=device)


def d_ff(config: dict) -> int:
    """The MLP width: ``n_inner``, or 4 x ``n_embd`` where it is null (as
    GPT-2 reads it)."""
    return int(config.get("n_inner") or 4 * config["n_embd"])


def lm_shapes(config: dict) -> Dict[str, Tuple[int, ...]]:
    """Parameter name -> shape of ``TransformerLM`` at ``config``'s widths
    (the Flax layout the program keeps: q/k/v kernels (d, H, hd), the out
    kernel (H, hd, d), dense kernels (in, out))."""
    d, h, f = config["n_embd"], config["n_head"], d_ff(config)
    v, p = config["vocab_size"], config["n_positions"]
    shapes = {"Embed_0.embedding": (v, d), "Embed_1.embedding": (p, d)}
    for i in range(config["n_layer"]):
        b = f"Block_{i}."
        for ln in ("LayerNorm_0", "LayerNorm_1"):
            shapes[b + ln + ".scale"] = (d,)
            shapes[b + ln + ".bias"] = (d,)
        for proj in ("query", "key", "value"):
            shapes[b + f"SelfAttention_0.{proj}.kernel"] = (d, h, d // h)
        shapes[b + "SelfAttention_0.out.kernel"] = (h, d // h, d)
        shapes[b + "Dense_0.kernel"] = (d, f)
        shapes[b + "Dense_1.kernel"] = (f, d)
    shapes["LayerNorm_0.scale"] = (d,)
    shapes["LayerNorm_0.bias"] = (d,)
    shapes["Dense_0.kernel"] = (d, v)
    return shapes


def _std(name: str, config: dict) -> float:
    """GPT-2's init: N(0, initializer_range) for every matrix and
    embedding, the residual projections (attention out, MLP down) scaled by
    1 / sqrt(2 n_layer)."""
    std = float(config["initializer_range"])
    if name.endswith("SelfAttention_0.out.kernel") or name.endswith("Dense_1.kernel"):
        std /= math.sqrt(2 * config["n_layer"])
    return std


def lm_weights(config: dict, seed: int, device, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Random weights for ``config`` from ``seed``: every matrix drawn in
    one ``randn`` call over one flat ``dtype`` buffer and scaled in place
    slice by slice; LayerNorm scales 1 and biases 0. The returned tensors
    are views of that buffer."""
    shapes = lm_shapes(config)
    drawn = [k for k in shapes if not (k.endswith(".scale") or k.endswith(".bias"))]
    total = sum(math.prod(shapes[k]) for k in drawn)
    flat = torch.randn(total, generator=generator(seed, device, stream=2), device=device, dtype=dtype)
    out, at = {}, 0
    for k in drawn:
        size = math.prod(shapes[k])
        out[k] = flat[at:at + size].view(shapes[k]).mul_(_std(k, config))
        at += size
    for k in shapes:
        if k.endswith(".scale"):
            out[k] = torch.ones(shapes[k], device=device, dtype=dtype)
        elif k.endswith(".bias"):
            out[k] = torch.zeros(shapes[k], device=device, dtype=dtype)
    return out


def sample_steps(traffic: dict, seed: int) -> list:
    """The steps whose outputs are compared with the reference, drawn from
    the seed among the first ``pool_steps`` (``checked_steps`` of them)."""
    g = torch.Generator().manual_seed((int(seed) * 1_000_003 + 3) & _SEED_MASK)
    pick = torch.randperm(int(traffic["pool_steps"]), generator=g)[: int(traffic["checked_steps"])]
    return sorted(int(i) for i in pick)
