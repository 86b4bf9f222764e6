"""Models of the port: InceptionV3 (FID's default feature extractor), the
transformer LM, the long-context LM on ring attention, and the port's own
DeepSeek-V3-family LM (``MLAMoELM``: multi-head latent attention and the
dropless top-k expert layer of ``parallel.moe.moe_topk_dropless``;
Moonlight-16B-A3B at its default ``MLAMoEConfig``), and the hybrid
``KimiLinearLM`` (Kimi Delta Attention layers on ``ops.kda``, NoPE latent
attention and the same expert layer over a held share of the experts;
Kimi-Linear-48B-A3B at its default ``KimiLinearConfig``)."""

from torcheval_tpu_torch.models.inception import (
    FEATURE_DIM,
    InceptionV3,
    from_flax_variables,
    init_inception_params,
    load_torchvision_inception_params,
)
from torcheval_tpu_torch.models.long_context import (
    init_long_context_lm,
    long_context_lm,
    perplexity_counters,
)
from torcheval_tpu_torch.models.kimi_linear import KimiLinearConfig, KimiLinearLM
from torcheval_tpu_torch.models.mla_moe import MLAMoEConfig, MLAMoELM
from torcheval_tpu_torch.models.transformer import (
    TransformerLM,
    init_params,
    param_specs,
)

__all__ = [
    "TransformerLM",
    "init_params",
    "param_specs",
    "init_long_context_lm",
    "long_context_lm",
    "perplexity_counters",
    "FEATURE_DIM",
    "InceptionV3",
    "from_flax_variables",
    "init_inception_params",
    "load_torchvision_inception_params",
    "MLAMoEConfig",
    "MLAMoELM",
    "KimiLinearConfig",
    "KimiLinearLM",
]
