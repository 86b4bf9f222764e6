"""Cells cut to sizes the CPU tests run in about a second."""

from __future__ import annotations

import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

# the tests run beside other test processes: a few threads each keep a
# timed window from starving
torch.set_num_threads(2)


def tiny(cell):
    """``cell`` cut to a size the CPU runs in well under a second: a CTR
    eval set of 2^15 samples in batches of 4,096 (8 a pass), or a
    two-layer LM of width 64 over a 512-id vocabulary."""
    cfg, tr = dict(cell.config), dict(cell.traffic)
    if cfg["loop"] == "panel_pass":
        cfg["samples"] = 1 << 15
        tr.update(batch=4096, trace={"start_batch": 2, "batches": 2})
    else:
        cfg.update(vocab_size=512, n_embd=64, n_head=4, n_layer=2, n_positions=64, n_inner=None)
        tr.update(windows_per_step=2, window=32, pool_steps=4, checked_steps=2,
                  trace={"start_step": 1, "steps": 1})
    return dataclasses.replace(cell, config=cfg, traffic=tr)
