"""A realistic eval panel: five metrics a batch, synced and checkpointed.

The torch counterpart of the reference pattern most eval loops want:

- ``toolkit.update_collection`` updates the multiclass metrics --
  accuracy, macro F1, the confusion matrix -- on one batch in one call;
- derived streams ride beside them: was-the-argmax-right as a windowed
  rate (``WindowedClickThroughRate``) and the predicted class's confidence
  scored against correctness (``StreamingBinaryAUROC``, whose histogram
  update is the fused-AUC CUDA kernel on the card);
- ``sync_and_compute_collection`` values the panel mid-stream (a world of
  one here; the same call syncs ranks over a process group);
- ``save_metric_state``/``load_metric_state`` round-trip the panel, so a
  resumed eval continues where it stopped. Run:

    python -m torcheval_tpu_torch.examples.eval_panel_example --device cpu

``--device cuda`` (the default) keeps every metric state on the card.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

import torcheval_tpu_torch.metrics as M
from torcheval_tpu_torch.metrics.toolkit import sync_and_compute_collection, update_collection
from torcheval_tpu_torch.utils import load_metric_state, save_metric_state

CLASSES, BATCH, STEPS = 10, 256, 12


def make_panel(device):
    return {
        "accuracy": M.MulticlassAccuracy(device=device),
        "f1_macro": M.MulticlassF1Score(num_classes=CLASSES, average="macro", device=device),
        "confusion": M.MulticlassConfusionMatrix(CLASSES, device=device),
        "win_acc": M.WindowedClickThroughRate(max_num_updates=4, device=device),
        "confidence_auroc": M.StreamingBinaryAUROC(device=device),
    }


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    gen = torch.Generator(device).manual_seed(args.seed)
    panel = make_panel(device)

    values = {}
    for step in range(1, STEPS + 1):
        # a model would produce these; the panel only sees (logits, labels)
        logits = torch.randn((BATCH, CLASSES), generator=gen, device=device)
        labels = torch.randint(0, CLASSES, (BATCH,), generator=gen, device=device)
        update_collection({k: panel[k] for k in ("accuracy", "f1_macro", "confusion")},
                          logits, labels)
        correct = (logits.argmax(dim=-1) == labels).to(torch.float32)
        confidence = torch.softmax(logits, dim=-1).amax(dim=-1)
        panel["win_acc"].update(correct)
        panel["confidence_auroc"].update(confidence, correct)

        if step % 4 == 0:
            values = sync_and_compute_collection(panel)
            # windowed metrics return (lifetime, windowed), (num_tasks,) each
            windowed = float(values["win_acc"][1][0])
            print(f"step {step:2d}: acc={float(values['accuracy']):.3f} "
                  f"f1={float(values['f1_macro']):.3f} win_acc={windowed:.3f} "
                  f"conf_auroc={float(values['confidence_auroc']):.3f}")

    with tempfile.TemporaryDirectory() as ckpt_dir:
        path = os.path.join(ckpt_dir, "panel")
        save_metric_state(panel, path)
        restored = make_panel(device)
        load_metric_state(restored, path)
        before = float(panel["accuracy"].compute())
        after = float(restored["accuracy"].compute())
        assert abs(before - after) < 1e-7, (before, after)
        print(f"checkpoint round-trip ok: accuracy {after:.3f}")

    cm = panel["confusion"].compute().to(torch.float64)
    trace_fraction = float(cm.trace() / cm.sum())
    print(f"confusion matrix trace fraction: {trace_fraction:.3f}")
    print("eval panel done")
    return {
        "accuracy": float(values["accuracy"]), "f1_macro": float(values["f1_macro"]),
        "confidence_auroc": float(values["confidence_auroc"]), "accuracy_restored": after,
        "trace_fraction": trace_fraction, "streaming_updates": STEPS,
        "samples": STEPS * BATCH,
    }


if __name__ == "__main__":
    main()
