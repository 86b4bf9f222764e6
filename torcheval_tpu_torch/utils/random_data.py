"""Random datasets for tests and examples (counterpart of
``torcheval_tpu/utils/random_data.py``). Each generator draws from a
``torch.Generator`` where the JAX package takes a key; the two packages
give the same shapes, dtypes and ranges, not the same values.

Data is made on ``device``: CUDA unless ``device="cpu"`` is passed. A
``generator`` must live on that device; ``None`` seeds a new one with 0.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from torcheval_tpu_torch.utils.convert import DeviceLike, canonicalize_device


def _generator(generator: Optional[torch.Generator], device: DeviceLike):
    dev = canonicalize_device(device)
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    return generator, dev


def _bits(shape, generator, device) -> torch.Tensor:
    """0/1 int32 targets."""
    return torch.randint(0, 2, shape, generator=generator, device=device).to(torch.int32)


def get_rand_data_binary(
    num_updates: int,
    num_tasks: int,
    batch_size: int,
    *,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random (input, target) pairs for binary metrics: float32 scores in
    [0, 1) and int32 0/1 targets, each (num_updates, num_tasks,
    batch_size), squeezed to (num_updates, batch_size) when num_tasks is
    1."""
    generator, dev = _generator(generator, device)
    shape = (num_updates, num_tasks, batch_size)
    input = torch.rand(shape, generator=generator, device=dev)
    targets = _bits(shape, generator, dev)
    if num_tasks == 1:
        input, targets = input.squeeze(1), targets.squeeze(1)
    return input, targets


def get_rand_data_multiclass(
    num_updates: int,
    num_classes: int,
    batch_size: int,
    *,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random (input, target) for multiclass metrics: float32 scores
    (num_updates, batch_size, num_classes) and int32 class targets
    (num_updates, batch_size)."""
    generator, dev = _generator(generator, device)
    input = torch.rand((num_updates, batch_size, num_classes), generator=generator, device=dev)
    targets = torch.randint(
        0, num_classes, (num_updates, batch_size), generator=generator, device=dev
    ).to(torch.int32)
    return input, targets


def get_rand_data_multilabel(
    num_updates: int,
    num_labels: int,
    batch_size: int,
    *,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random (input, target) for multilabel metrics: float32 scores and
    int32 0/1 targets, each (num_updates, batch_size, num_labels)."""
    generator, dev = _generator(generator, device)
    shape = (num_updates, batch_size, num_labels)
    return torch.rand(shape, generator=generator, device=dev), _bits(shape, generator, dev)


def get_rand_data_binned_binary(
    num_updates: int,
    num_tasks: int,
    batch_size: int,
    num_bins: int,
    *,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Random binary data (as ``get_rand_data_binary``) plus a sorted
    float32 threshold tensor of ``num_bins`` values in [0, 1], the first 0
    and the last 1."""
    generator, dev = _generator(generator, device)
    input, targets = get_rand_data_binary(
        num_updates, num_tasks, batch_size, generator=generator, device=dev
    )
    thresholds = torch.sort(torch.rand((num_bins,), generator=generator, device=dev)).values
    thresholds[0], thresholds[-1] = 0.0, 1.0
    return input, targets, thresholds
