"""torcheval_tpu_torch: the PyTorch/CUDA port of torcheval_tpu.

The same metric surface as the JAX package (module paths, public names,
state names, state dtypes and merge kinds), written in eager PyTorch. Class
metrics keep their state on a ``torch.device`` -- CUDA unless the caller
passes ``device="cpu"`` -- and the one TPU kernel of the JAX package, the
fused-AUC histogram, is a hand-written CUDA kernel for Hopper
(``ops/csrc/fused_auc_hist.cu``) with a plain PyTorch version beside it
for CPU tensors.

This package never imports ``jax`` or ``torcheval_tpu``; it keeps its own
copies of what it needs.
"""

from torcheval_tpu_torch.version import __version__

__all__ = ["__version__"]
