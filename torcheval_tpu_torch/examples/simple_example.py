"""Single-device training loop with in-loop metrics.

The torch counterpart of the reference's simple example: train a tiny
next-token model, update the metrics on every batch (no host sync),
``compute`` once an epoch and ``reset`` between epochs. Accuracy and F1
share one ``update_collection`` call a step. Run:

    python -m torcheval_tpu_torch.examples.simple_example --device cpu

``--device cuda`` (the default) keeps the model and the metric state on
the card.
"""

from __future__ import annotations

import argparse
import time

import torch
import torch.nn.functional as F

from torcheval_tpu_torch.metrics import Mean, MulticlassAccuracy, MulticlassF1Score, Throughput
from torcheval_tpu_torch.metrics.toolkit import update_collection

VOCAB, BATCH, SEQ, STEPS, EPOCHS = 64, 8, 16, 12, 2


class TinyLM(torch.nn.Module):
    """Embedding, one hidden layer, and a projection to the vocabulary."""

    def __init__(self, vocab: int, width: int = 32) -> None:
        super().__init__()
        self.embed = torch.nn.Embedding(vocab, width)
        self.hidden = torch.nn.Linear(width, width)
        self.out = torch.nn.Linear(width, vocab)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.out(torch.relu(self.hidden(self.embed(tokens))))


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    gen = torch.Generator(device).manual_seed(args.seed)
    torch.manual_seed(args.seed)

    model = TinyLM(VOCAB).to(device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    cls_metrics = {
        "acc": MulticlassAccuracy(device=device),
        "f1": MulticlassF1Score(num_classes=VOCAB, average="macro", device=device),
    }
    loss_mean = Mean(device=device)
    tput = Throughput(device=device)

    results = {}
    for epoch in range(EPOCHS):
        t0 = time.perf_counter()
        for _ in range(STEPS):
            # next-token data with structure to learn: token t is followed by t + 1
            tokens = torch.randint(0, VOCAB, (BATCH, SEQ), generator=gen, device=device)
            targets = (tokens + 1) % VOCAB
            logits = model(tokens)
            loss = F.cross_entropy(logits.reshape(-1, VOCAB), targets.reshape(-1))
            opt.zero_grad()
            loss.backward()
            opt.step()
            update_collection(cls_metrics, logits.detach().reshape(-1, VOCAB), targets.reshape(-1))
            loss_mean.update(loss.detach())
        tput.update(STEPS * BATCH * SEQ, time.perf_counter() - t0)
        results = {
            "loss": float(loss_mean.compute()),
            "acc": float(cls_metrics["acc"].compute()),
            "f1": float(cls_metrics["f1"].compute()),
            "tokens_per_s": tput.compute(),
        }
        print(f"epoch {epoch}: loss={results['loss']:.4f} acc={results['acc']:.4f} "
              f"f1={results['f1']:.4f} throughput={results['tokens_per_s']:.0f} tok/s")
        for metric in (*cls_metrics.values(), loss_mean):
            metric.reset()
    return results


if __name__ == "__main__":
    main()
