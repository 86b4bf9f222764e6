"""Sequence, expert and pipeline parallelism of the eval stack.

Counterpart of ``torcheval_tpu/parallel``: ring attention, top-1 MoE
dispatch and a GPipe schedule, each with its unsharded oracle. The mesh
axis of the JAX package is a ``group`` here (``parallel/_axis.py``): a
``torch.distributed`` group or a ``ThreadWorld`` view. Training runs
through them: :func:`backward` (``parallel/_axis.py``) back-propagates a
rank's loss through its collectives, on every rank in lockstep.
"""

from torcheval_tpu_torch.parallel._axis import backward
from torcheval_tpu_torch.parallel.moe import moe_apply, moe_reference
from torcheval_tpu_torch.parallel.pipeline import (
    pipeline_apply,
    pipeline_reference,
)
from torcheval_tpu_torch.parallel.ring_attention import (
    dense_reference_attention,
    ring_attention,
)

# the JAX package's names; ``backward`` is the port's own (its training
# runs through ``jax.grad``)
__all__ = [
    "dense_reference_attention",
    "moe_apply",
    "moe_reference",
    "pipeline_apply",
    "pipeline_reference",
    "ring_attention",
]
