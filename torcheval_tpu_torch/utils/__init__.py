"""Utilities: input coercion, cross-package state loading and random
test data."""

from torcheval_tpu_torch.utils.convert import (
    load_numpy_state_dict,
    numpy_state_dict,
)
from torcheval_tpu_torch.utils.random_data import (
    get_rand_data_binary,
    get_rand_data_binned_binary,
    get_rand_data_multiclass,
    get_rand_data_multilabel,
)

__all__ = [
    "get_rand_data_binary",
    "get_rand_data_binned_binary",
    "get_rand_data_multiclass",
    "get_rand_data_multilabel",
    "load_numpy_state_dict",
    "numpy_state_dict",
]
