"""Keyed multi-tenant metric tables (counterpart of
``torcheval_tpu/table``): ``table.py`` for the subsystem docstring,
``panel.py`` for one-intake multi-family panels, ``streaming.py`` for
per-request decode quality, ``_admission.py`` for overload admission
control."""

from torcheval_tpu_torch.table._admission import (
    RUNG_NAMES,
    AdmissionController,
    AdmissionProvenance,
    ServingBudget,
    admission_keep,
    shedding_status,
)
from torcheval_tpu_torch.table._families import FAMILIES, TableFamily
from torcheval_tpu_torch.table._hash import hash_keys, owner_of
from torcheval_tpu_torch.table.panel import PanelValues, TablePanel
from torcheval_tpu_torch.table.streaming import (
    StreamTable,
    stream_logprob_family,
    stream_ngram_family,
    stream_token_accuracy_family,
    stream_token_edit_family,
)
from torcheval_tpu_torch.table.table import (
    MetricTable,
    TableValues,
    tightest_staleness_budget,
)

__all__ = [
    "FAMILIES",
    "AdmissionController",
    "AdmissionProvenance",
    "MetricTable",
    "PanelValues",
    "RUNG_NAMES",
    "ServingBudget",
    "StreamTable",
    "TableFamily",
    "TablePanel",
    "TableValues",
    "admission_keep",
    "hash_keys",
    "owner_of",
    "shedding_status",
    "stream_logprob_family",
    "stream_ngram_family",
    "stream_token_accuracy_family",
    "stream_token_edit_family",
    "tightest_staleness_budget",
]
