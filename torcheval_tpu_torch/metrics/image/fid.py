"""FrechetInceptionDistance class metric (counterpart of
``torcheval_tpu/metrics/image/fid.py``).

State is each distribution's feature sum and uncentered covariance sum,
SUM-merged, so a sync moves O(feature_dim^2) numbers whatever the image
count. The Frechet distance is the JAX package's real-symmetric form,
``tr sqrt(S1 S2) = tr sqrt(sqrt(S1) S2 sqrt(S1))``: one ``eigh`` of the
real covariance, then ``eigvalsh`` of the symmetrized inner product, with
eigenvalues clamped at 0. It runs in float32 on the metric's device (on a
card, cuSOLVER), where the JAX package moves it to the host CPU. The two
float32 routes round differently: on mean-dominated features (second
moments 9,000 times the covariances' trace) an NVIDIA H100's value sat
5.8e-3 of ``tr S1 + tr S2`` from the CPU's, and 5.1e-3 from the same
function in float64 (``chip_smoke.py``'s ``image`` phase).

The default feature extractor, ``FIDInceptionV3``, is the port's
InceptionV3 (``torcheval_tpu_torch.models.inception``) behind the
reference's bilinear 299x299 resize. Its convolutions run with PyTorch's
defaults, as the reference torcheval's do on a CUDA card: cuDNN may use
TF32 (``torch.backends.cudnn.allow_tf32`` is ``True`` by default), which
rounds conv inputs to a 10-bit mantissa; wrap the update in
``torch.backends.cudnn.flags(allow_tf32=False)`` for float32 convs. Any
callable ``images (N, 3, H, W) -> activations (N, feature_dim)`` serves in
its place.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Mapping, Optional, TypeVar, Union

import torch
import torch.nn.functional as F
from torch import nn

from torcheval_tpu_torch.config import debug_validation_enabled
from torcheval_tpu_torch.metrics.metric import MergeKind, Metric
from torcheval_tpu_torch.utils.convert import DeviceLike

TFrechetInceptionDistance = TypeVar(
    "TFrechetInceptionDistance", bound="FrechetInceptionDistance"
)

FeatureExtractor = Callable[[torch.Tensor], torch.Tensor]


class FIDInceptionV3(nn.Module):
    """The port's InceptionV3 wrapped for FID: NCHW input resized to
    299x299 by ``F.interpolate(mode="bilinear", align_corners=False,
    antialias=False)``, 2048-d pooled features, run under
    ``torch.inference_mode()``.

    ``weights`` is an ``InceptionV3`` state dict (from
    ``init_inception_params``, ``from_flax_variables`` or
    ``load_torchvision_inception_params``). Without it torchvision's
    pretrained weights are loaded, which needs torchvision: without
    torchvision this raises ``ImportError``.
    """

    def __init__(self, weights: Optional[Mapping[str, Any]] = None) -> None:
        from torcheval_tpu_torch.models.inception import (
            InceptionV3,
            load_torchvision_inception_params,
        )

        super().__init__()
        if weights is None:
            try:
                weights = load_torchvision_inception_params()
            except ImportError as e:
                raise ImportError(
                    "You must have torchvision installed to use FID with "
                    "pretrained InceptionV3 weights; pass `weights` (an "
                    "InceptionV3 state dict) or a custom `model` otherwise."
                ) from e
        else:
            weights = load_torchvision_inception_params(weights)
        self.model = InceptionV3()
        self.model.load_state_dict(weights, strict=True)
        self.requires_grad_(False)
        self.eval()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return self.model(_resize_299(images))


def _resize_299(images: torch.Tensor) -> torch.Tensor:
    """The reference's bilinear resize to 299x299 (no antialias when
    downscaling), which ``jax.image.resize(..., antialias=False)``
    matches in the JAX package."""
    return F.interpolate(
        images, size=(299, 299), mode="bilinear", align_corners=False, antialias=False
    )


def _fid_accumulate(activations: torch.Tensor):
    return (
        torch.sum(activations, dim=0),
        torch.matmul(activations.T, activations),
        torch.tensor(activations.shape[0], dtype=torch.int32, device=activations.device),
    )


def _covariance(total: torch.Tensor, cov_sum: torch.Tensor, n: torch.Tensor):
    mean = total / n
    cov = (cov_sum - n * torch.outer(mean, mean)) / (n - 1)
    return mean, cov


def _frechet_distance(
    real_sum: torch.Tensor,
    real_cov_sum: torch.Tensor,
    num_real: torch.Tensor,
    fake_sum: torch.Tensor,
    fake_cov_sum: torch.Tensor,
    num_fake: torch.Tensor,
) -> torch.Tensor:
    real_mean, real_cov = _covariance(real_sum, real_cov_sum, num_real.to(torch.float32))
    fake_mean, fake_cov = _covariance(fake_sum, fake_cov_sum, num_fake.to(torch.float32))
    mean_diff_squared = torch.sum(torch.square(real_mean - fake_mean))
    trace_sum = torch.trace(real_cov) + torch.trace(fake_cov)

    # tr sqrt(S1 S2) == tr sqrt(sqrt(S1) S2 sqrt(S1)) for PSD S1, S2. JAX's
    # eigh symmetrizes its input, (a + a^T) / 2, before it decomposes
    evals1, evecs1 = torch.linalg.eigh((real_cov + real_cov.T) / 2)
    sqrt_real = (evecs1 * torch.sqrt(torch.clamp(evals1, min=0.0))) @ evecs1.T
    inner = sqrt_real @ fake_cov @ sqrt_real
    inner = (inner + inner.T) / 2  # symmetrize numerical noise
    inner_evals = torch.linalg.eigvalsh(inner)
    sqrt_eigenvals_sum = torch.sum(torch.sqrt(torch.clamp(inner_evals, min=0.0)))
    return mean_diff_squared + trace_sum - 2 * sqrt_eigenvals_sum


class FrechetInceptionDistance(Metric[torch.Tensor]):
    """Frechet Inception Distance between real and generated image
    distributions (https://arxiv.org/pdf/1706.08500.pdf).

    Args:
        model: callable mapping images ``(N, 3, H, W)`` to activations
            ``(N, feature_dim)``; an ``nn.Module`` is moved to the metric's
            device and put in ``eval()`` mode. If ``None``,
            ``FIDInceptionV3()`` with torchvision's pretrained weights.
        feature_dim: activation dimensionality (2048 for InceptionV3).

    >>> import torch
    >>> from torcheval_tpu_torch.metrics import FrechetInceptionDistance
    >>> def extractor(images):  # (N, 3, H, W) -> (N, 4)
    ...     pooled = images.mean(dim=(2, 3))
    ...     spread = images.var(dim=(1, 2, 3), correction=0)[:, None]
    ...     return torch.cat([pooled, spread], dim=1)
    >>> metric = FrechetInceptionDistance(model=extractor, feature_dim=4, device="cpu")
    >>> real = torch.stack([torch.full((3, 4, 4), 0.1 * i) for i in range(1, 9)])
    >>> _ = metric.update(real, is_real=True).update(real * 0.8, is_real=False)
    >>> round(float(metric.compute()), 3)
    0.031
    """

    def __init__(
        self,
        model: Optional[FeatureExtractor] = None,
        feature_dim: int = 2048,
        device: DeviceLike = None,
    ) -> None:
        super().__init__(device=device)
        self._FID_parameter_check(model=model, feature_dim=feature_dim)
        if model is None:
            model = FIDInceptionV3()
        self.model = model
        self._place_model()

        self._add_state("real_sum", torch.zeros(feature_dim), merge=MergeKind.SUM)
        self._add_state(
            "real_cov_sum", torch.zeros((feature_dim, feature_dim)), merge=MergeKind.SUM
        )
        self._add_state("fake_sum", torch.zeros(feature_dim), merge=MergeKind.SUM)
        self._add_state(
            "fake_cov_sum", torch.zeros((feature_dim, feature_dim)), merge=MergeKind.SUM
        )
        self._add_state(
            "num_real_images", torch.zeros((), dtype=torch.int32), merge=MergeKind.SUM
        )
        self._add_state(
            "num_fake_images", torch.zeros((), dtype=torch.int32), merge=MergeKind.SUM
        )

    def _place_model(self) -> None:
        if isinstance(self.model, nn.Module):
            self.model.to(self._device).eval().requires_grad_(False)
        elif hasattr(self.model, "to"):
            self.model.to(self._device)

    def update(self: TFrechetInceptionDistance, images, is_real: bool) -> TFrechetInceptionDistance:
        """Accumulate a batch of real or generated images (N, 3, H, W)."""
        # dtype-preserving first, so the float32 check sees the caller's dtype
        images = self._input(images)
        self._FID_update_input_check(images=images, is_real=is_real)
        with torch.no_grad():
            activations = self.model(images.to(torch.float32))
        names = (
            ("real_sum", "real_cov_sum", "num_real_images")
            if is_real
            else ("fake_sum", "fake_cov_sum", "num_fake_images")
        )
        return self._apply_update_plan((_fid_accumulate, names, (activations,), ()))

    def compute(self) -> torch.Tensor:
        """FID of the accumulated statistics; 0.0 with a ``RuntimeWarning``
        until at least one real and one fake image have been seen."""
        num_real = int(self.num_real_images)
        num_fake = int(self.num_fake_images)
        if num_real == 0 or num_fake == 0:
            warnings.warn(
                "Computing FID requires at least 1 real image and 1 fake "
                f"image, but currently running with {num_real} real images "
                f"and {num_fake} fake images. Returning 0.0",
                RuntimeWarning,
            )
            return torch.zeros((), device=self.device)
        return _frechet_distance(
            self.real_sum, self.real_cov_sum, self.num_real_images,
            self.fake_sum, self.fake_cov_sum, self.num_fake_images,
        )

    def _FID_parameter_check(self, model: Optional[FeatureExtractor], feature_dim: int) -> None:
        if feature_dim is None or feature_dim <= 0:
            raise RuntimeError("feature_dim has to be a positive integer")
        if model is None and feature_dim != 2048:
            raise RuntimeError(
                "When the default Inception v3 model is used, feature_dim "
                "needs to be set to 2048"
            )

    def _FID_update_input_check(self, images: torch.Tensor, is_real: bool) -> None:
        if images.ndim != 4:
            raise ValueError(
                f"Expected 4D tensor as input. But input has {images.ndim} "
                "dimenstions."
            )
        if images.shape[1] != 3:
            raise ValueError(f"Expected 3 channels as input. Got {images.shape[1]}.")
        if type(is_real) != bool:  # noqa: E721 -- the reference's check
            raise ValueError(
                f"Expected 'real' to be of type bool but got {type(is_real)}.",
            )
        if isinstance(self.model, FIDInceptionV3):
            if images.dtype != torch.float32:
                raise ValueError(
                    "When default inception-v3 model is used, images expected "
                    f"to be `float32`, but got {images.dtype}."
                )
            # a host readback, debug-tier only (the reference checks eagerly)
            if debug_validation_enabled() and (
                float(torch.min(images)) < 0 or float(torch.max(images)) > 1
            ):
                raise ValueError(
                    "When default inception-v3 model is used, images are "
                    "expected to be in the [0, 1] interval"
                )

    def to(
        self: TFrechetInceptionDistance,
        device: Union[str, torch.device],
        *args: Any,
        **kwargs: Any,
    ) -> TFrechetInceptionDistance:
        super().to(device, *args, **kwargs)
        self._place_model()
        return self
