"""Model tools: FLOP counting and module summaries.

Counterpart of ``torcheval_tpu/tools`` (and the reference torcheval's
``tools``): counts come from aten dispatch on fake tensors, summaries from
one hooked forward.
"""

from torcheval_tpu_torch.tools.flops import (
    FlopCounter,
    count_flops,
    count_flops_backward,
)
from torcheval_tpu_torch.tools.module_summary import (
    ModuleSummary,
    get_module_summary,
    get_summary_table,
    prune_module_summary,
)

__all__ = [
    "FlopCounter",
    "ModuleSummary",
    "count_flops",
    "count_flops_backward",
    "get_module_summary",
    "get_summary_table",
    "prune_module_summary",
]
