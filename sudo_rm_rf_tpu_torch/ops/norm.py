"""Normalization ops (counterpart of ``sudo_rm_rf_tpu/ops/norm.py``).

GlobLN — Global Layer Norm — normalizes each batch element over ALL non-batch
dims (channels AND time), then applies a learned per-channel gain/bias. eps is
added to the *population* variance before the square root.
"""

from __future__ import annotations

import torch


def glob_ln(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    *,
    eps: float = 1e-8,
) -> torch.Tensor:
    """Global layer norm over all non-batch dims of a (N, C, ...) tensor.

    gamma/beta are (C,) and broadcast along every trailing dim.
    """
    dims = tuple(range(1, x.ndim))
    shape = (1, -1) + (1,) * (x.ndim - 2)
    if x.dtype == torch.float32:
        mean = x.mean(dim=dims, keepdim=True)
        var = (x - mean).square().mean(dim=dims, keepdim=True)
        normed = (x - mean) * torch.rsqrt(var + eps)
        return gamma.reshape(shape) * normed + beta.reshape(shape)
    # low precision: fp32 statistics, folded scale/shift applied in the
    # input dtype so tensor traffic stays narrow
    x32 = x.float()
    mean = x32.mean(dim=dims, keepdim=True)
    var = (x32 - mean).square().mean(dim=dims, keepdim=True)
    inv = torch.rsqrt(var + eps)
    g32 = gamma.float().reshape(shape)
    sc = (g32 * inv).to(x.dtype)
    sh = (beta.float().reshape(shape) - g32 * inv * mean).to(x.dtype)
    return sc * x + sh
