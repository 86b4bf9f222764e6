"""Image class metrics: FID and PSNR."""

from torcheval_tpu_torch.metrics.image.fid import FrechetInceptionDistance
from torcheval_tpu_torch.metrics.image.psnr import PeakSignalNoiseRatio

__all__ = ["FrechetInceptionDistance", "PeakSignalNoiseRatio"]
