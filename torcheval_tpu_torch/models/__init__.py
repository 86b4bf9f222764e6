"""Models of the port: InceptionV3, FID's default feature extractor."""

from torcheval_tpu_torch.models.inception import (
    FEATURE_DIM,
    InceptionV3,
    from_flax_variables,
    init_inception_params,
    load_torchvision_inception_params,
)

__all__ = [
    "FEATURE_DIM",
    "InceptionV3",
    "from_flax_variables",
    "init_inception_params",
    "load_torchvision_inception_params",
]
