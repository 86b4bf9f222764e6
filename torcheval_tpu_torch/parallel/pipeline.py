"""Pipeline parallelism: GPipe-style microbatched stages over an axis.

Counterpart of ``torcheval_tpu/parallel/pipeline.py``. Layers are split
into S stages, one a rank of a ``pp`` axis; a batch split into M
microbatches streams through them. Each tick every stage applies its
layers to the microbatch it holds and passes the activation one hop down
the ring with ``ppermute``: the (M + S - 1)-tick GPipe schedule, bubble
(S - 1)/(M + S - 1). The last stage's outputs reach every rank by one
``psum``.

The axis is a ``group`` (``parallel/_axis.py``)::

    out = pipeline_apply(stage_fn, my_stage_params, x_microbatches, group=pp_group)
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils._pytree import tree_leaves, tree_map

from torcheval_tpu_torch.parallel._axis import axis_index, axis_size, ppermute, psum


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,
    x: torch.Tensor,
    *,
    group: Any,
) -> torch.Tensor:
    """Stream microbatches through the pipeline stages on ``group``.

    Args:
        stage_fn: ``(params, activation) -> activation`` for ONE stage; the
            activation's shape is kept.
        stage_params: this rank's stage parameters.
        x: ``(M, mb, ...)`` microbatched input, the same on every rank.
        group: the pipeline axis.

    Returns the ``(M, mb, ...)`` pipeline output on every rank (the last
    stage's outputs, summed over the axis with zeros elsewhere).
    """
    num_stages = axis_size(group)
    stage = axis_index(group)
    num_micro = x.shape[0]
    is_last = stage == num_stages - 1

    # ring neighbours: stage s hands its activation to s+1 (the wrap edge
    # S-1 -> 0 carries retired activations; they are never read)
    perm = [(i, (i + 1) % num_stages) for i in range(num_stages)]
    arriving = torch.zeros_like(x[0])
    outputs = torch.zeros_like(x)
    for t in range(num_micro + num_stages - 1):
        # stage 0 injects microbatch t (clamped: past M it re-reads the
        # last microbatch, whose result never lands in `outputs`)
        inp = x[min(t, num_micro - 1)] if stage == 0 else arriving
        out = stage_fn(stage_params, inp)
        # the last stage finished microbatch t-(S-1) this tick
        done = t - (num_stages - 1)
        if is_last and done >= 0:
            outputs[done] = out
        arriving = ppermute(out, group, perm)
    return psum(outputs, group)


def pipeline_reference(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stacked_params: Any,
    x: torch.Tensor,
) -> torch.Tensor:
    """Unsharded oracle: all S stages in turn on each microbatch.

    ``stacked_params`` leaves carry the stage axis in front (``(S, ...)``);
    ``x`` is ``(M, mb, ...)`` as in :func:`pipeline_apply`.
    """
    num_stages = tree_leaves(stacked_params)[0].shape[0]
    out = x
    for s in range(num_stages):
        params_s = tree_map(lambda a: a[s], stacked_params)
        out = torch.stack([stage_fn(params_s, mb) for mb in out])
    return out
