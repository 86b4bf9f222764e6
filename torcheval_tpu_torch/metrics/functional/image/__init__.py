"""Functional image metrics."""

from torcheval_tpu_torch.metrics.functional.image.psnr import peak_signal_noise_ratio

__all__ = ["peak_signal_noise_ratio"]
