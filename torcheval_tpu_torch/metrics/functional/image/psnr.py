"""Peak signal-to-noise ratio (counterpart of
``torcheval_tpu/metrics/functional/image/psnr.py``). An update returns the
sum of squared errors and a float32 observation count; the auto-range
class form also keeps running min/max of the target."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from torcheval_tpu_torch.metrics.functional.tensor_utils import check_reducible
from torcheval_tpu_torch.utils.convert import (
    DeviceLike,
    functional_device,
    narrow_64,
    to_torch_float,
)


def _psnr_update(input: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    sum_squared_error = torch.sum(torch.square(input - target))
    # a fill, not torch.tensor: no upload of host data on the update path
    n = torch.full((), float(target.numel()), dtype=torch.float32, device=target.device)
    return sum_squared_error, n


def _psnr_accumulate(sum_squared_error, num_observations, min_target, max_target, input, target):
    """Every auto-range state advanced, and the derived data range."""
    d_sse, d_n = _psnr_update(input, target)
    new_min = torch.minimum(min_target, torch.amin(target))
    new_max = torch.maximum(max_target, torch.amax(target))
    return sum_squared_error + d_sse, num_observations + d_n, new_min, new_max, new_max - new_min


def _psnr_compute(
    sum_squared_error: torch.Tensor, num_observations: torch.Tensor, data_range: torch.Tensor
) -> torch.Tensor:
    mse = sum_squared_error / num_observations
    return 10 * torch.log10(torch.square(data_range) / mse)


def _psnr_param_check(data_range: Optional[float]) -> None:
    if data_range is not None:
        if type(data_range) is not float:
            raise ValueError("`data_range needs to be either `None` or `float`.")
        if data_range <= 0:
            raise ValueError("`data_range` needs to be positive.")


def _psnr_input_check(input: torch.Tensor, target: torch.Tensor) -> None:
    if input.shape != target.shape:
        raise ValueError(
            "The `input` and `target` must have the same shape, "
            f"got shapes {tuple(input.shape)} and {tuple(target.shape)}."
        )


def peak_signal_noise_ratio(
    input,
    target,
    data_range: Optional[float] = None,
    *,
    device: DeviceLike = None,
) -> torch.Tensor:
    """PSNR between two images, (N, C, H, W) each. ``data_range`` is the
    images' range, a positive ``float``; ``None`` takes ``target.max() -
    target.min()`` (class version: ``PeakSignalNoiseRatio``).

    >>> import torch
    >>> from torcheval_tpu_torch.metrics.functional import peak_signal_noise_ratio
    >>> input = torch.tensor([[0.1, 0.2], [0.3, 0.4]])
    >>> peak_signal_noise_ratio(input, input * 0.9)
    tensor(19.8767)
    """
    _psnr_param_check(data_range)
    dev = functional_device(device, input, target)
    input = narrow_64(to_torch_float(input, device=dev))
    target = narrow_64(to_torch_float(target, device=dev))
    _psnr_input_check(input, target)
    sse, n = _psnr_update(input, target)
    if data_range is None:
        check_reducible(target, "max")
        dr = torch.amax(target) - torch.amin(target)
    else:
        dr = torch.tensor(data_range, dtype=torch.float32, device=dev)
    return _psnr_compute(sse, n, dr)
