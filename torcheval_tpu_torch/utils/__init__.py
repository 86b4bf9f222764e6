"""Utilities: input coercion and cross-package state loading."""

from torcheval_tpu_torch.utils.convert import (
    load_numpy_state_dict,
    numpy_state_dict,
)

__all__ = ["load_numpy_state_dict", "numpy_state_dict"]
