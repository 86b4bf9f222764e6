"""Utilities: input coercion, cross-package state loading, random test
data, CUDA-graph capture counting (``CompileCounter``) and metric
checkpoints (``save_metric_state``/``load_metric_state``,
from ``utils.checkpoint``, imported on first use: the metrics import this
package, and the checkpoint module imports the metrics)."""

from torcheval_tpu_torch.utils.compile_counter import CompileCounter
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
    "CompileCounter",
    "get_rand_data_binary",
    "get_rand_data_binned_binary",
    "get_rand_data_multiclass",
    "get_rand_data_multilabel",
    "load_metric_state",
    "load_numpy_state_dict",
    "numpy_state_dict",
    "save_metric_state",
]


def __getattr__(name):
    if name in ("load_metric_state", "save_metric_state"):
        from torcheval_tpu_torch.utils import checkpoint

        return getattr(checkpoint, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
