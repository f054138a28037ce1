"""1-D convolutions (counterpart of ``sudo_rm_rf_tpu/ops/conv.py``).

Same signatures and layouts as the JAX package: input (N, C_in, T), conv
weight (C_out, C_in / groups, K), transposed-conv weight (C_in, C_out / groups,
K). Both are the library convolutions: the encoder and decoder run outside the
U-ConvBlock kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv1d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    stride: int = 1,
    padding: int = 0,
    dilation: int = 1,
    groups: int = 1,
) -> torch.Tensor:
    """torch.nn.functional.conv1d with the JAX package's keyword interface."""
    return F.conv1d(x, weight, bias, stride=stride, padding=padding,
                    dilation=dilation, groups=groups)


def conv_transpose1d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    stride: int = 1,
    padding: int = 0,
    output_padding: int = 0,
    groups: int = 1,
) -> torch.Tensor:
    """torch.nn.functional.conv_transpose1d with the JAX package's keyword
    interface. T_out = (T-1)*stride - 2*padding + K + output_padding."""
    return F.conv_transpose1d(x, weight, bias, stride=stride, padding=padding,
                              output_padding=output_padding, groups=groups)
