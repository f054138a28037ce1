"""ConvTasNet baseline (Luo & Mesgarani), counterpart of
``sudo_rm_rf_tpu/models/baselines/convtasnet.py``.

  * encoder Conv1d(1 -> N, win, stride win//2, bias-free)
  * TCN separator: GroupNorm(1) (causal: cumulative LN) -> 1x1 bottleneck ->
    stack x layer DepthConv1d blocks at dilation 2^i, residual and skip
    paths; causal blocks pad on the left only
  * sigmoid masks (B, S, N, L) on the encoder output, one shared bias-free
    ConvTranspose1d decoder applied per masked source
  * the input padded to a window multiple plus the stride on both ends,
    cropped back after the decoder
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sudo_rm_rf_tpu_torch import ops
from sudo_rm_rf_tpu_torch.models.layers import (
    Conv1d,
    ConvTranspose1d,
    PReLU,
    default_generator,
    kaiming_uniform_conv,
)
from sudo_rm_rf_tpu_torch.models.sudormrf import GroupNorm1


class CumulativeLN(nn.Module):
    """The causal cumulative LN with (1, C, 1) params ``gain``/``bias``."""

    def __init__(self, channels: int, eps: float = 1e-8, *, device=None):
        super().__init__()
        self.eps = eps
        self.gain = nn.Parameter(torch.ones(1, channels, 1, device=device))
        self.bias = nn.Parameter(torch.zeros(1, channels, 1, device=device))

    def forward(self, x):
        return ops.cumulative_ln(x, self.gain.reshape(-1), self.bias.reshape(-1), eps=self.eps)


def _norm(channels: int, causal: bool, device):
    return CumulativeLN(channels, device=device) if causal else GroupNorm1(channels,
                                                                          device=device)


class DepthConv1d(nn.Module):
    """1x1 -> PReLU -> norm -> depthwise dilated -> PReLU -> norm ->
    (residual 1x1, skip 1x1)."""

    def __init__(self, input_channel: int, hidden_channel: int, kernel: int, padding: int,
                 dilation: int = 1, skip: bool = True, causal: bool = False, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        g = default_generator(generator)
        self.skip, self.causal = skip, causal
        self.pad = (kernel - 1) * dilation if causal else padding
        self.conv1d = Conv1d(input_channel, hidden_channel, 1, generator=g, device=device)
        self.nonlinearity1 = PReLU(device=device)
        self.reg1 = _norm(hidden_channel, causal, device)
        self.dconv1d = Conv1d(hidden_channel, hidden_channel, kernel, dilation=dilation,
                              groups=hidden_channel, padding=self.pad, generator=g,
                              device=device)
        self.nonlinearity2 = PReLU(device=device)
        self.reg2 = _norm(hidden_channel, causal, device)
        self.res_out = Conv1d(hidden_channel, input_channel, 1, generator=g, device=device)
        if skip:
            self.skip_out = Conv1d(hidden_channel, input_channel, 1, generator=g,
                                   device=device)

    def forward(self, x):
        y = self.reg1(self.nonlinearity1(self.conv1d(x)))
        y = self.dconv1d(y)
        if self.causal:
            y = y[:, :, :-self.pad]
        y = self.reg2(self.nonlinearity2(y))
        residual = self.res_out(y)
        if self.skip:
            return residual, self.skip_out(y)
        return residual


class TCN(nn.Module):
    """The dilated temporal conv network."""

    def __init__(self, input_dim: int, output_dim: int, bn_dim: int, hidden_dim: int,
                 layer: int = 8, stack: int = 3, kernel: int = 3, skip: bool = True,
                 causal: bool = False, dilated: bool = True, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        g = default_generator(generator)
        self.skip = skip
        self.LN = _norm(input_dim, causal, device)
        self.BN = Conv1d(input_dim, bn_dim, 1, generator=g, device=device)
        self.TCN = nn.ModuleList(
            DepthConv1d(bn_dim, hidden_dim, kernel, padding=2**i if dilated else 1,
                        dilation=2**i if dilated else 1, skip=skip, causal=causal,
                        generator=g, device=device)
            for _ in range(stack) for i in range(layer))
        self.output = nn.Sequential(PReLU(device=device),
                                    Conv1d(bn_dim, output_dim, 1, generator=g, device=device))

    def forward(self, x):
        y = self.BN(self.LN(x))
        skip_sum = 0.0
        for block in self.TCN:
            if self.skip:
                residual, skip = block(y)
                y = y + residual
                skip_sum = skip_sum + skip
            else:
                y = y + block(y)
        return self.output(skip_sum if self.skip else y)


class ConvTasNet(nn.Module):
    """TasNet front and back end around the TCN separator. Input (B, [1,] T),
    output (B, num_spk, T). Defaults: the published configuration (enc 512,
    feature 128, 2 ms windows, 8 x 3 layers; 5.05 M params)."""

    def __init__(self, enc_dim: int = 512, feature_dim: int = 128, sr: int = 8000,
                 win: float = 2, layer: int = 8, stack: int = 3, kernel: int = 3,
                 num_spk: int = 2, causal: bool = False, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        g = default_generator(generator)
        self.enc_dim, self.num_spk, self.causal = enc_dim, num_spk, causal
        self.win_samples = int(sr * win / 1000)
        w = self.win_samples
        self.encoder = Conv1d(1, enc_dim, w, stride=w // 2, use_bias=False, generator=g,
                              device=device)
        self.TCN = TCN(enc_dim, enc_dim * num_spk, feature_dim, feature_dim * 4, layer=layer,
                       stack=stack, kernel=kernel, causal=causal, generator=g, device=device)
        self.decoder = ConvTranspose1d(enc_dim, 1, w, stride=w // 2,
                                       weight_init=kaiming_uniform_conv, generator=g,
                                       device=device)

    def forward(self, x):
        if x.ndim == 2:
            x = x[:, None, :]
        win = self.win_samples
        stride = win // 2
        b, nsample = x.shape[0], x.shape[-1]
        rest = win - (stride + nsample % win) % win
        x = F.pad(x, (stride, rest + stride))
        enc = self.encoder(x)
        masks = torch.sigmoid(self.TCN(enc)).reshape(b, self.num_spk, self.enc_dim, -1)
        masked = enc[:, None, :, :] * masks  # (B, S, N, L)
        out = self.decoder(masked.reshape(b * self.num_spk, self.enc_dim, -1))
        out = out[:, :, stride:-(rest + stride)]
        return out.reshape(b, self.num_spk, -1)
