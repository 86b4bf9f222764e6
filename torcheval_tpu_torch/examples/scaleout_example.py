"""Evaluating with every scale-out axis: sp, pp and ep in one script.

A long sequence evaluated with exact ring attention over a
sequence-parallel axis, a deep MLP streamed through a GPipe pipeline, and
an MoE block routed over an expert-parallel axis, each with metric
counters computed on the sharded outputs and merged over the axis by a
collective, then loaded into the metric. The axes are ``ThreadWorld``
views, one rank thread each (``--world`` of them), which is how several
ranks share one card; a ``torch.distributed`` group works the same. Run:

    python -m torcheval_tpu_torch.examples.scaleout_example --device cpu

``--device cuda`` (the default) runs every rank on the card.
"""

from __future__ import annotations

import argparse

import torch

from torcheval_tpu_torch.metrics import MeanSquaredError, MulticlassAccuracy, Perplexity
from torcheval_tpu_torch.metrics.functional.classification.accuracy import (
    _multiclass_accuracy_update,
)
from torcheval_tpu_torch.metrics.functional.text.perplexity import _perplexity_update_jit
from torcheval_tpu_torch.parallel import _axis, moe_apply, pipeline_apply, ring_attention
from torcheval_tpu_torch.utils.test_utils import ThreadWorld


def _load(metric, states):
    """Counters into ``metric``, each in its state's dtype."""
    metric.load_state_dict({k: v.to(getattr(metric, k).dtype) for k, v in states.items()})
    return metric


@torch.no_grad()
def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--world", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    device, n = torch.device(args.device), args.world
    gen = torch.Generator(device).manual_seed(args.seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    print(f"ranks: {n}")
    out = {"world": n}

    # ---- sp: ring attention over a sequence-sharded eval batch ----------
    batch, seq, heads, dim, vocab = 2, 8 * n, 2, 16, 32
    q, k, v = randn(batch, seq, heads, dim), randn(batch, seq, heads, dim), randn(batch, seq, heads, dim)
    w_out = randn(heads * dim, vocab, scale=0.2)
    targets = torch.randint(0, vocab, (batch, seq), generator=gen, device=device)
    blk = seq // n

    def sp_eval(g):
        cut = slice(g.rank * blk, (g.rank + 1) * blk)
        attn = ring_attention(q[:, cut], k[:, cut], v[:, cut], group=g, causal=True)
        logits = attn.reshape(*attn.shape[:2], -1) @ w_out
        nll, count = _perplexity_update_jit(logits, targets[:, cut], None)
        return _axis.psum(torch.stack([nll, count.to(torch.float32)]), g)

    nll, count = ThreadWorld(n).run(sp_eval)[0]
    ppl = _load(Perplexity(device=device), {"sum_log_probs": nll, "num_total": count})
    out["sp_perplexity"] = float(ppl.compute())
    print(f"sp ring-attention perplexity={out['sp_perplexity']:.3f} "
          f"over {seq}-token sequences on {n} shards")

    # ---- pp: a deep stack pipelined over the ranks ----------------------
    n_micro, mb, width = 4, 4, 16
    stage_w = randn(n, width, width, scale=0.5)
    xs = randn(n_micro, mb, width)
    cls_targets = torch.randint(0, width, (n_micro, mb), generator=gen, device=device)

    def stage_fn(p, h):
        return torch.tanh(h @ p["w"])

    def pp_eval(g):
        logits = pipeline_apply(stage_fn, {"w": stage_w[g.rank]}, xs, group=g)
        nc, nt = _multiclass_accuracy_update(logits.reshape(-1, width), cls_targets.reshape(-1),
                                             "micro", None, 1)
        return torch.stack([nc.to(torch.float32), nt])

    nc, nt = ThreadWorld(n).run(pp_eval)[0]
    acc = _load(MulticlassAccuracy(device=device), {"num_correct": nc, "num_total": nt})
    out["pp_accuracy"] = float(acc.compute())
    print(f"pp pipeline accuracy={out['pp_accuracy']:.3f} ({n} stages, {n_micro} microbatches)")

    # ---- ep: an MoE layer routed across the ranks -----------------------
    tok_per_shard, hid = 8, 32
    wg = randn(width, n)
    w1, w2 = randn(n, width, hid, scale=0.3), randn(n, hid, width, scale=0.3)
    toks = randn(n * tok_per_shard, width)
    clean = randn(n * tok_per_shard, width)

    def ep_forward(g):
        cut = slice(g.rank * tok_per_shard, (g.rank + 1) * tok_per_shard)
        return moe_apply(toks[cut], wg, w1[g.rank], w2[g.rank], group=g, capacity=tok_per_shard)

    recon = torch.cat(ThreadWorld(n).run(ep_forward))
    mse = MeanSquaredError(device=device)
    mse.update(recon, clean)
    out["ep_mse"] = float(mse.compute())
    print(f"ep MoE reconstruction mse={out['ep_mse']:.3f} ({n} experts, all_to_all dispatch)")

    # ---- composed dp x sp: ring attention inside a data-parallel step ---
    if n >= 4 and n % 2 == 0:
        dp, sp = 2, n // 2
        seq_c = 8 * sp
        qc, kc, vc = (randn(dp * 2, seq_c, heads, dim) for _ in range(3))
        blk_c = seq_c // sp

        def dpsp_eval(g):
            rows = [g.new_subgroup([r * sp + c for c in range(sp)]) for r in range(dp)]
            cols = [g.new_subgroup([r * sp + c for r in range(dp)]) for c in range(sp)]
            row, col = g.rank // sp, g.rank % sp
            cut = (slice(2 * row, 2 * row + 2), slice(col * blk_c, (col + 1) * blk_c))
            attn = ring_attention(qc[cut], kc[cut], vc[cut], group=rows[row], causal=True)
            positive = torch.sum(attn > 0).to(torch.float32)
            return _axis.psum(_axis.psum(positive, rows[row]), cols[col])

        pos = float(ThreadWorld(n).run(dpsp_eval)[0])
        out["dpsp_pos_frac"] = pos / (dp * 2 * seq_c * heads * dim)
        print(f"dpxsp composed ring attention ok (mesh {dp}x{sp}, seq {seq_c}, "
              f"pos_frac={out['dpsp_pos_frac']:.3f})")
    else:
        print(f"dpxsp composed leg skipped (needs an even world >= 4; have {n})")

    print("scaleout done")
    return out


if __name__ == "__main__":
    main()
