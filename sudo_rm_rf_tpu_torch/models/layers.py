"""Layer library for the SuDoRM-RF family (counterpart of
``sudo_rm_rf_tpu/models/layers.py``).

Parameter and submodule names are the torch reference's (``weight``,
``bias``, ``gamma``, ``beta``; ``conv``, ``norm``, ``act``), so its
``state_dict`` loads strictly. Every parameter is drawn on the host from an
explicit ``torch.Generator`` (the same seed gives the same weights on any
device) and then moved to ``device``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from sudo_rm_rf_tpu_torch import ops


def default_generator(generator: Optional[torch.Generator]) -> torch.Generator:
    """The given generator, or a fresh one seeded with 0."""
    return generator if generator is not None else torch.Generator().manual_seed(0)


def _uniform(shape, bound: float, generator: torch.Generator) -> torch.Tensor:
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


def kaiming_uniform_conv(shape, generator: torch.Generator) -> torch.Tensor:
    """torch's default Conv1d weight init: bound = 1/sqrt(fan_in)."""
    return _uniform(shape, 1.0 / math.sqrt(shape[1] * shape[2]), generator)


def xavier_uniform_conv(shape, generator: torch.Generator) -> torch.Tensor:
    """xavier_uniform on a conv weight (out, in/g, k), as the reference
    initializes the encoder and decoder."""
    fan_in, fan_out = shape[1] * shape[2], shape[0] * shape[2]
    return _uniform(shape, math.sqrt(6.0 / (fan_in + fan_out)), generator)


class Conv1d(nn.Module):
    """nn.Conv1d with torch param layout (weight: (out, in/g, k))."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 groups: int = 1, use_bias: bool = True,
                 weight_init: Callable = kaiming_uniform_conv, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        g = default_generator(generator)
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        shape = (out_channels, in_channels // groups, kernel_size)
        self.weight = nn.Parameter(weight_init(shape, g).to(device))
        if use_bias:
            bound = 1.0 / math.sqrt(shape[1] * kernel_size)
            self.bias = nn.Parameter(_uniform((out_channels,), bound, g).to(device))
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        return ops.conv1d(x, self.weight, self.bias, stride=self.stride,
                          padding=self.padding, dilation=self.dilation,
                          groups=self.groups)


class ConvTranspose1d(nn.Module):
    """Bias-free nn.ConvTranspose1d with torch param layout (weight: (in,
    out, k)) and xavier init, as the reference's decoder."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, output_padding: int = 0, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.output_padding = output_padding
        shape = (in_channels, out_channels, kernel_size)
        self.weight = nn.Parameter(
            xavier_uniform_conv(shape, default_generator(generator)).to(device))

    def forward(self, x):
        return ops.conv_transpose1d(
            x, self.weight, stride=self.stride, padding=self.padding,
            output_padding=self.output_padding)


class PReLU(nn.Module):
    """torch.nn.PReLU with a scalar slope stored with shape (1,), init 0.25."""

    def __init__(self, *, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), 0.25, device=device))

    def forward(self, x):
        return torch.where(x >= 0, x, self.weight[0] * x)


class GlobLN(nn.Module):
    """Global layer norm module (params gamma/beta)."""

    def __init__(self, channels: int, *, device=None):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(channels, device=device))
        self.beta = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x):
        return ops.glob_ln(x, self.gamma, self.beta)


class ConvNormAct(nn.Module):
    """Conv1d -> GlobLN -> PReLU; padding (k-1)//2."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, groups: int = 1, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.conv = Conv1d(in_channels, out_channels, kernel_size, stride=stride,
                           padding=(kernel_size - 1) // 2, groups=groups,
                           generator=generator, device=device)
        self.norm = GlobLN(out_channels, device=device)
        self.act = PReLU(device=device)

    def forward(self, x):
        return self.act(self.norm(self.conv(x)))


class NormAct(nn.Module):
    """GlobLN -> PReLU."""

    def __init__(self, channels: int, *, device=None):
        super().__init__()
        self.norm = GlobLN(channels, device=device)
        self.act = PReLU(device=device)

    def forward(self, x):
        return self.act(self.norm(x))


class DilatedConvNorm(nn.Module):
    """(Possibly dilated/strided/grouped) Conv1d -> GlobLN; padding
    ((k-1)//2)*dilation."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, groups: int = 1, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.conv = Conv1d(in_channels, out_channels, kernel_size, stride=stride,
                           padding=((kernel_size - 1) // 2) * dilation,
                           dilation=dilation, groups=groups,
                           generator=generator, device=device)
        self.norm = GlobLN(out_channels, device=device)

    def forward(self, x):
        return self.norm(self.conv(x))
