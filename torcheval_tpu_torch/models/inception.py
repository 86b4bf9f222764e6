"""InceptionV3 as an ``nn.Module``: the FID feature extractor.

Counterpart of ``torcheval_tpu/models/inception.py``, the JAX package's
Flax InceptionV3, with the same architecture: ``BasicConv2d`` (conv
without bias, ``BatchNorm2d(eps=1e-3)``, relu), the ``Mixed_5*``/``6*``/
``7*`` blocks and the trunk with torchvision's ``transform_input``
remap, returning the 2048-d pooled features (no fc, no aux head).

- Layout is NCHW, as torch convolutions expect. Module and parameter
  names are torchvision's (``Mixed_5b.branch1x1.conv.weight``,
  ``….bn.running_var``), so a torchvision state dict loads with a strict
  ``load_state_dict`` once its ``fc.*`` and ``AuxLogits.*`` entries are
  dropped (``load_torchvision_inception_params`` does that and checks the
  rest).
- The 3x3 stride-1 average pools count their zero padding
  (``count_include_pad=True``), as Flax's ``avg_pool`` divides by 9
  everywhere; max pools take no padding.
- The module is built in ``eval()`` mode: batch norm uses its running
  statistics, never the batch's.
- ``from_flax_variables`` carries the JAX package's ``{"params",
  "batch_stats"}`` tree across: conv kernels HWIO -> OIHW, batch-norm
  ``scale``/``bias`` -> ``weight``/``bias``, ``mean``/``var`` ->
  ``running_mean``/``running_var``.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

FEATURE_DIM = 2048


class BasicConv2d(nn.Module):
    """conv (no bias) -> batchnorm(eps=0.001) -> relu, as in torchvision."""

    def __init__(self, in_channels: int, out_channels: int, **conv_kwargs: Any) -> None:
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, bias=False, **conv_kwargs)
        self.bn = nn.BatchNorm2d(out_channels, eps=0.001)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool3(x: torch.Tensor) -> torch.Tensor:
    # Flax divides the zero-padded window sum by 9 everywhere
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, in_channels: int, pool_features: int) -> None:
        super().__init__()
        self.branch1x1 = BasicConv2d(in_channels, 64, kernel_size=1)
        self.branch5x5_1 = BasicConv2d(in_channels, 48, kernel_size=1)
        self.branch5x5_2 = BasicConv2d(48, 64, kernel_size=5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 64, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, kernel_size=3, padding=1)
        self.branch_pool = BasicConv2d(in_channels, pool_features, kernel_size=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool3(x))
        return torch.cat([b1, b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, in_channels: int) -> None:
        super().__init__()
        self.branch3x3 = BasicConv2d(in_channels, 384, kernel_size=3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 64, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, kernel_size=3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, _max_pool(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, in_channels: int, channels_7x7: int) -> None:
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(in_channels, 192, kernel_size=1)
        self.branch7x7_1 = BasicConv2d(in_channels, c7, kernel_size=1)
        self.branch7x7_2 = BasicConv2d(c7, c7, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_channels, c7, kernel_size=1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, kernel_size=(1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_channels, 192, kernel_size=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for layer in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                      self.branch7x7dbl_5):
            bd = layer(bd)
        bp = self.branch_pool(_avg_pool3(x))
        return torch.cat([b1, b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, in_channels: int) -> None:
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_channels, 192, kernel_size=1)
        self.branch3x3_2 = BasicConv2d(192, 320, kernel_size=3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_channels, 192, kernel_size=1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, kernel_size=3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for layer in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = layer(b7)
        return torch.cat([b3, b7, _max_pool(x)], 1)


class InceptionE(nn.Module):
    def __init__(self, in_channels: int) -> None:
        super().__init__()
        self.branch1x1 = BasicConv2d(in_channels, 320, kernel_size=1)
        self.branch3x3_1 = BasicConv2d(in_channels, 384, kernel_size=1)
        self.branch3x3_2a = BasicConv2d(384, 384, kernel_size=(1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, kernel_size=(3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 448, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, kernel_size=3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, kernel_size=(1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, kernel_size=(3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_channels, 192, kernel_size=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = self.branch_pool(_avg_pool3(x))
        return torch.cat([b1, b3, bd, bp], 1)


_MIXED = (
    ("Mixed_5b", InceptionA, (192, 32)),
    ("Mixed_5c", InceptionA, (256, 64)),
    ("Mixed_5d", InceptionA, (288, 64)),
    ("Mixed_6a", InceptionB, (288,)),
    ("Mixed_6b", InceptionC, (768, 128)),
    ("Mixed_6c", InceptionC, (768, 160)),
    ("Mixed_6d", InceptionC, (768, 160)),
    ("Mixed_6e", InceptionC, (768, 192)),
    ("Mixed_7a", InceptionD, (768,)),
    ("Mixed_7b", InceptionE, (1280,)),
    ("Mixed_7c", InceptionE, (2048,)),
)


class InceptionV3(nn.Module):
    """InceptionV3 trunk producing (N, 2048) pooled features.

    Input: NCHW float images already resized to 299x299, in [0, 1] (75x75
    is the smallest the trunk takes). ``transform_input`` is torchvision's
    channelwise remap from [0, 1] to the ImageNet-normalized scale the
    pretrained weights expect. The module starts in ``eval()`` mode.
    """

    def __init__(self, transform_input: bool = True) -> None:
        super().__init__()
        self.transform_input = transform_input
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, kernel_size=3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, kernel_size=3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, kernel_size=3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, kernel_size=1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, kernel_size=3)
        for name, block, args in _MIXED:
            setattr(self, name, block(*args))
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.transform_input:
            x = torch.cat([
                x[:, 0:1] * (0.229 / 0.5) + (0.485 - 0.5) / 0.5,
                x[:, 1:2] * (0.224 / 0.5) + (0.456 - 0.5) / 0.5,
                x[:, 2:3] * (0.225 / 0.5) + (0.406 - 0.5) / 0.5,
            ], 1)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _max_pool(x)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = _max_pool(x)
        for name, _, _ in _MIXED:
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))


def _parameter_shapes() -> Dict[str, Tuple[int, ...]]:
    """Every parameter and statistic the module loads, by torchvision
    name, with its shape (from a module on the meta device: nothing is
    allocated)."""
    with torch.device("meta"):
        module = InceptionV3()
    return {
        name: tuple(t.shape)
        for name, t in module.state_dict().items()
        if not name.endswith("num_batches_tracked")
    }


def init_inception_params(generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """Random weights for ``InceptionV3`` as a state dict (CPU float32),
    drawn from ``generator`` (a CPU ``torch.Generator``; seed 0 when
    ``None``): He-scaled conv kernels, batch-norm scales and running
    variances in [0.5, 1.5], biases and running means N(0, 0.1^2), which
    keep the activations from vanishing or blowing up over the 94 conv
    layers."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    state: Dict[str, torch.Tensor] = {}
    for name, shape in sorted(_parameter_shapes().items()):
        if name.endswith(("bn.running_var", "bn.weight")):
            value = torch.rand(shape, generator=generator) + 0.5
        elif name.endswith(("bn.running_mean", "bn.bias")):
            value = torch.randn(shape, generator=generator) * 0.1
        else:  # conv kernel, OIHW
            fan_in = int(np.prod(shape[1:]))
            value = torch.randn(shape, generator=generator) * (2.0 / fan_in) ** 0.5
        state[name] = value
    return state


def load_torchvision_inception_params(
    state_dict: Optional[Mapping] = None,
) -> Dict[str, torch.Tensor]:
    """A torchvision ``inception_v3`` state dict checked and trimmed into
    ``InceptionV3``'s: ``fc.*``, ``AuxLogits.*`` and ``num_batches_tracked``
    are skipped, every other entry must name a parameter of the module
    with its shape, and every parameter must be set. Values may be
    tensors or numpy arrays.

    With ``state_dict=None`` torchvision's pretrained weights are loaded,
    which needs torchvision (``ImportError`` without it) and its
    downloaded checkpoint.

    Raises ``KeyError`` on an unknown name and ``ValueError`` on a shape
    mismatch or a parameter left unset: a partial import would give
    plausible but wrong FID features.
    """
    if state_dict is None:
        from torchvision import models  # optional dependency, imported on use

        state_dict = models.inception_v3(weights="DEFAULT").state_dict()
    expected = _parameter_shapes()
    out: Dict[str, torch.Tensor] = {}
    for name, value in state_dict.items():
        parts = name.split(".")
        if parts[0] in ("fc", "AuxLogits") or parts[-1] == "num_batches_tracked":
            continue  # fc removed (the reference's fid.py); aux head unused
        if name not in expected:
            raise KeyError(f"unrecognized torchvision inception parameter '{name}'")
        if not isinstance(value, torch.Tensor):
            value = torch.from_numpy(np.array(value))
        if tuple(value.shape) != expected[name]:
            raise ValueError(
                f"shape mismatch at {name}: {tuple(value.shape)} vs {expected[name]}"
            )
        out[name] = value.detach().to(torch.float32).contiguous()
    missing = sorted(set(expected) - set(out))
    if missing:
        raise ValueError(
            f"{len(missing)} InceptionV3 parameters were not covered by the "
            f"state dict, e.g. {missing[:5]}"
        )
    return out


# Flax leaf -> torch leaf; conv kernels also go HWIO -> OIHW
_FLAX_LEAVES = {
    ("params", "kernel"): "weight",
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def from_flax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's InceptionV3 variables (``{"params": ...,
    "batch_stats": ...}``, leaves as numpy arrays or anything
    ``np.asarray`` reads) as ``InceptionV3``'s state dict: conv ``kernel``
    HWIO -> ``weight`` OIHW, batch-norm ``scale``/``bias`` ->
    ``weight``/``bias``, ``batch_stats`` ``mean``/``var`` ->
    ``running_mean``/``running_var``. Checked as
    ``load_torchvision_inception_params`` checks (an unknown name, a shape
    mismatch or a parameter left unset raises)."""
    state: Dict[str, Any] = {}
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(variables[collection]):
            *module_path, leaf = path
            if (collection, leaf) not in _FLAX_LEAVES:
                raise KeyError(f"unrecognized Flax leaf {collection}/{'/'.join(path)}")
            value = np.asarray(value, dtype=np.float32)
            if leaf == "kernel":
                value = value.transpose(3, 2, 0, 1)
            state[".".join(module_path + [_FLAX_LEAVES[collection, leaf]])] = value
    return load_torchvision_inception_params(state)
