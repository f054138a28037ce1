"""Layers the baselines share: torch's ``nn.Linear`` (channels last),
``nn.LSTM`` and a 1x1 ``nn.Conv2d``, with torch's param names and every
param drawn from an explicit ``torch.Generator``."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sudo_rm_rf_tpu_torch.models.layers import _uniform, default_generator


class Linear(nn.Module):
    """torch ``nn.Linear`` over the last dim: weight (out, in), bias (out,),
    both uniform in +-1/sqrt(in)."""

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        g = default_generator(generator)
        bound = 1.0 / math.sqrt(in_features)
        self.weight = nn.Parameter(_uniform((out_features, in_features), bound, g).to(device))
        if use_bias:
            self.bias = nn.Parameter(_uniform((out_features,), bound, g).to(device))
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


def torch_lstm(input_size: int, hidden_size: int, num_layers: int = 1,
               bidirectional: bool = False, *, generator: Optional[torch.Generator] = None,
               device=None) -> nn.LSTM:
    """``nn.LSTM(batch_first=True)`` (gates i, f, g, o; ``weight_ih_l{k}``,
    ``..._reverse``), every param uniform in +-1/sqrt(hidden) from
    ``generator``. Built on the meta device first, so torch's own init never
    draws from the global RNG."""
    g = default_generator(generator)
    lstm = nn.LSTM(input_size, hidden_size, num_layers=num_layers, batch_first=True,
                   bidirectional=bidirectional, device="meta")
    bound = 1.0 / math.sqrt(hidden_size)
    for name in list(lstm._flat_weights_names):
        shape = getattr(lstm, name).shape
        setattr(lstm, name, nn.Parameter(_uniform(shape, bound, g).to(device)))
    return lstm


class Conv2d1x1(nn.Module):
    """torch ``nn.Conv2d(in, out, 1)``: a pointwise linear over the channels
    of (B, C, H, W), weight (out, in, 1, 1)."""

    def __init__(self, in_channels: int, out_channels: int, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        g = default_generator(generator)
        bound = 1.0 / math.sqrt(in_channels)
        self.weight = nn.Parameter(
            _uniform((out_channels, in_channels, 1, 1), bound, g).to(device))
        self.bias = nn.Parameter(_uniform((out_channels,), bound, g).to(device))

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias)
