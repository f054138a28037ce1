"""Original SuDoRM-RF v1 (the "softmax" variant), counterpart of
``sudo_rm_rf_tpu/models/sudormrf.py``.

  * every norm is ``nn.GroupNorm(1, C, eps=1e-8)``: the global layer norm of
    the improved variant, with torch's param names ``weight``/``bias``
  * PReLUs are per-channel, ``nn.PReLU(C)``
  * encoder Conv1d(1 -> N, k=L, stride L//2, pad L//2, bias) + ReLU
  * UBlock: proj + depthwise ladder + reverse upsample-add, then NormAct ->
    ConvNorm(in -> out) -> NormAct(out + x)
  * a 1x1 reshape conv when out_channels != enc_num_basis
  * mask head Conv2d(1 -> S, kernel (N+1, 1), height padding N - N//2) over
    (B, 1, N, T), softmax over sources (a sigmoid when S == 1), times the
    encoder features
  * decoder: ConvTranspose1d(S*N -> S) grouped by source, with a bias
  * input padded to a multiple of lcm(L//2, 2**depth)
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sudo_rm_rf_tpu_torch import ops
from sudo_rm_rf_tpu_torch.models.layers import (
    Conv1d,
    ConvTranspose1d,
    PReLU,
    _uniform,
    default_generator,
    kaiming_uniform_conv,
)


class GroupNorm1(nn.Module):
    """torch ``nn.GroupNorm(1, C, eps=1e-8)``: a global LN with torch-named
    params. (``nn.GroupNorm``'s default eps is 1e-5.)"""

    def __init__(self, channels: int, *, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x):
        return ops.glob_ln(x, self.weight, self.bias, eps=1e-8)


class ConvNorm(nn.Module):
    """Conv1d (padding (k-1)//2) -> GroupNorm1; the JAX package's
    ``DilatedConvNorm`` too, which v1 runs at dilation 1 only."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, groups: int = 1, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.conv = Conv1d(in_channels, out_channels, kernel_size, stride=stride,
                           padding=(kernel_size - 1) // 2, groups=groups,
                           generator=generator, device=device)
        self.norm = GroupNorm1(out_channels, device=device)

    def forward(self, x):
        return self.norm(self.conv(x))


class ConvNormAct(ConvNorm):
    """Conv1d -> GroupNorm1 -> per-channel PReLU."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, groups: int = 1, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         groups=groups, generator=generator, device=device)
        self.act = PReLU(out_channels, device=device)

    def forward(self, x):
        return self.act(self.norm(self.conv(x)))


class NormAct(nn.Module):
    """GroupNorm1 -> per-channel PReLU."""

    def __init__(self, channels: int, *, device=None):
        super().__init__()
        self.norm = GroupNorm1(channels, device=device)
        self.act = PReLU(channels, device=device)

    def forward(self, x):
        return self.act(self.norm(x))


class UBlock(nn.Module):
    """REDUCE -> SPLIT -> TRANSFORM -> MERGE block."""

    def __init__(self, out_channels: int = 128, in_channels: int = 512,
                 upsampling_depth: int = 4, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        g = default_generator(generator)
        self.depth = upsampling_depth
        self.proj_1x1 = ConvNormAct(out_channels, in_channels, 1, generator=g, device=device)
        self.spp_dw = nn.ModuleList(
            ConvNorm(in_channels, in_channels, kernel_size=5, stride=1 if k == 0 else 2,
                     groups=in_channels, generator=g, device=device)
            for k in range(upsampling_depth))
        self.final_norm = NormAct(in_channels, device=device)
        self.conv_1x1_exp = ConvNorm(in_channels, out_channels, 1, generator=g, device=device)
        self.module_act = NormAct(out_channels, device=device)

    def forward(self, x):
        cur = self.spp_dw[0](self.proj_1x1(x))
        pyramid = [cur]
        for k in range(1, self.depth):
            cur = self.spp_dw[k](cur)
            pyramid.append(cur)
        acc = pyramid[-1]
        for k in range(self.depth - 2, -1, -1):
            acc = pyramid[k] + ops.upsample_nearest_2x(acc)
        expanded = self.conv_1x1_exp(self.final_norm(acc))
        return self.module_act(expanded + x)


class MaskConv2d(nn.Module):
    """The softmax mask head: Conv2d(1 -> S, kernel (N+1, 1)) over (B, 1, N,
    T) with height padding N - N//2."""

    def __init__(self, num_sources: int, enc_num_basis: int, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        g = default_generator(generator)
        kh = enc_num_basis + 1
        bound = 1.0 / math.sqrt(kh)
        self.pad_h = enc_num_basis - enc_num_basis // 2
        self.weight = nn.Parameter(_uniform((num_sources, 1, kh, 1), bound, g).to(device))
        self.bias = nn.Parameter(_uniform((num_sources,), bound, g).to(device))

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, padding=(self.pad_h, 0))


class SuDORMRFv1(nn.Module):
    """SuDoRM-RF v1 separator. Input (B, 1, T) mixture, output (B, S, T)."""

    def __init__(self, out_channels: int = 128, in_channels: int = 512,
                 num_blocks: int = 16, upsampling_depth: int = 4,
                 enc_kernel_size: int = 21, enc_num_basis: int = 512,
                 num_sources: int = 2, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        g = default_generator(generator)
        self.out_channels, self.in_channels = out_channels, in_channels
        self.num_blocks, self.upsampling_depth = num_blocks, upsampling_depth
        self.enc_kernel_size, self.enc_num_basis = enc_kernel_size, enc_num_basis
        self.num_sources = num_sources
        half = enc_kernel_size // 2
        self.encoder = nn.Sequential(
            Conv1d(1, enc_num_basis, enc_kernel_size, stride=half, padding=half,
                   generator=g, device=device),
            nn.ReLU())
        self.ln = GroupNorm1(enc_num_basis, device=device)
        self.l1 = Conv1d(enc_num_basis, out_channels, 1, generator=g, device=device)
        self.sm = nn.Sequential(*(
            UBlock(out_channels, in_channels, upsampling_depth, generator=g, device=device)
            for _ in range(num_blocks)))
        if out_channels != enc_num_basis:
            self.reshape_before_masks = Conv1d(out_channels, enc_num_basis, 1, generator=g,
                                               device=device)
        self.m = MaskConv2d(num_sources, enc_num_basis, generator=g, device=device)
        self.decoder = ConvTranspose1d(
            enc_num_basis * num_sources, num_sources, enc_kernel_size, stride=half,
            padding=half, output_padding=half - 1, groups=num_sources, use_bias=True,
            weight_init=kaiming_uniform_conv, generator=g, device=device)

    @property
    def lcm(self) -> int:
        half, depth = self.enc_kernel_size // 2, 2**self.upsampling_depth
        return abs(half * depth) // math.gcd(half, depth)

    def forward(self, input_wav):
        if input_wav.ndim == 2:
            input_wav = input_wav[:, None, :]
        in_len = input_wav.shape[-1]
        x = ops.pad_to_multiple(input_wav, self.lcm)
        s = self.encoder(x)
        x = self.sm(self.l1(self.ln(s)))
        if self.out_channels != self.enc_num_basis:
            x = self.reshape_before_masks(x)
        x = self.m(x[:, None, :, :])
        x = torch.sigmoid(x) if self.num_sources == 1 else torch.softmax(x, dim=1)
        x = x * s[:, None, :, :]
        b = x.shape[0]
        est = self.decoder(x.reshape(b, -1, x.shape[-1]))
        return ops.unpad_to_length(est, in_len)
