"""LLM evaluation loop: perplexity, BLEU and accuracy on a language model.

The BASELINE config-4 workload shape (``Perplexity`` + ``BLEUScore`` over an
LM eval loop) on the port's ``TransformerLM``, and the division of labor
the text family is built around:

- ``Perplexity`` and ``MulticlassAccuracy`` consume the logits where they
  are (the card), a gather and masked sums a batch, no host sync;
- ``BLEUScore`` consumes strings (n-gram counting is string work, as in
  the reference) made here by a greedy decode;
- a long-context variant runs the same eval sequence-sharded: the
  long-context LM with ring attention over ``--sp`` rank threads of a
  ``ThreadWorld``, each rank's perplexity counters summed with ``psum``.
  Run:

    python -m torcheval_tpu_torch.examples.llm_eval_example --device cpu

``--device cuda`` (the default) runs the model and the metrics on the card.
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from torcheval_tpu_torch.metrics import BLEUScore, MulticlassAccuracy, Perplexity, Throughput
from torcheval_tpu_torch.models import (
    TransformerLM,
    init_long_context_lm,
    init_params,
    long_context_lm,
    perplexity_counters,
)
from torcheval_tpu_torch.parallel import _axis
from torcheval_tpu_torch.utils.test_utils import ThreadWorld

VOCAB, BATCH, SEQ, STEPS = 128, 8, 32, 6
PAD = 0  # ignore_index for perplexity

WORDS = np.array("the cat sat on a mat while dog ran far away and then some".split())


def detok(ids) -> str:
    """Token ids -> whitespace 'sentence' (toy vocabulary for the BLEU leg)."""
    return " ".join(WORDS[np.asarray(ids) % len(WORDS)])


def long_context_perplexity(device, gen, sp: int) -> float:
    """The sequence-sharded eval: two sequences of ``SEQ * sp`` tokens, a
    block of ``SEQ`` a rank, ring attention over the ranks, the counters
    summed over them."""
    long_seq = SEQ * sp
    params = init_long_context_lm(gen, vocab_size=VOCAB, d_model=64, n_heads=4, n_layers=2,
                                  d_ff=128, max_len=long_seq, device=device)
    tokens = torch.randint(1, VOCAB, (2, long_seq), generator=gen, device=device)
    targets = torch.randint(1, VOCAB, (2, long_seq), generator=gen, device=device)

    def rank(g):
        cut = slice(g.rank * SEQ, (g.rank + 1) * SEQ)
        logits = long_context_lm(params, tokens[:, cut], group=g)
        counters = perplexity_counters(logits, targets[:, cut], ignore_index=PAD)
        return {k: _axis.psum(c, g) for k, c in counters.items()}

    counters = ThreadWorld(sp).run(rank)[0]
    return math.exp(float(counters["sum_log_probs"] / counters["num_total"]))


@torch.no_grad()
def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--sp", type=int, default=2)
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    gen = torch.Generator(device).manual_seed(args.seed)
    model = TransformerLM(vocab_size=VOCAB, d_model=64, n_heads=4, n_layers=2, device=device)
    init_params(model, gen)

    ppl = Perplexity(ignore_index=PAD, device=device)
    acc = MulticlassAccuracy(device=device)
    bleu = BLEUScore(n_gram=4, device=device)
    tput = Throughput(device=device)

    start = time.perf_counter()
    for _ in range(STEPS):
        tokens = torch.randint(1, VOCAB, (BATCH, SEQ), generator=gen, device=device)
        targets = torch.roll(tokens, -1, dims=-1)
        targets[:, -1] = PAD  # no target for the last position
        logits = model(tokens)
        pred = logits.argmax(dim=-1)

        # on the card: accuracy has no ignore_index, so drop the PAD
        # positions perplexity skips
        ppl.update(logits, targets)
        flat_targets = targets.reshape(-1)
        keep = flat_targets != PAD
        acc.update(logits.reshape(-1, VOCAB)[keep], flat_targets[keep])

        # on the host: decode and count n-grams (the padded final position
        # carries no target, so it stays out of BLEU too)
        pred_host, targets_host = pred.cpu().numpy(), targets.cpu().numpy()
        bleu.update([detok(row[:-1]) for row in pred_host],
                    [[detok(row[:-1])] for row in targets_host])
    tput.update(STEPS * BATCH * SEQ, time.perf_counter() - start)
    out = {
        "perplexity": float(ppl.compute()), "accuracy": float(acc.compute()),
        "bleu": float(bleu.compute()), "tokens_per_s": float(tput.compute()),
    }
    print(f"perplexity={out['perplexity']:.2f} next-token-acc={out['accuracy']:.4f} "
          f"bleu={out['bleu']:.4f} throughput={out['tokens_per_s']:.0f} tok/s")

    out["long_context_perplexity"] = long_context_perplexity(device, gen, args.sp)
    print(f"long-context perplexity={out['long_context_perplexity']:.2f} "
          f"({SEQ * args.sp}-token sequences, ring attention x{args.sp})")
    return out


if __name__ == "__main__":
    main()
