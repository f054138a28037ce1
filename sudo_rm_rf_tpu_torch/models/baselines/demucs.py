"""Demucs baseline (a Wave-U-Net-style encoder/decoder with a BiLSTM
bottleneck), counterpart of ``sudo_rm_rf_tpu/models/baselines/demucs.py``.

  * the (B, T) mixture padded by a hardcoded (7210, 7210), as upstream does
  * depth encoder layers: Conv1d(k=8, s=4, valid) + ReLU + the rewrite 1x1 +
    GLU; channels grow by ``growth``
  * the optional linear-upsample ("Wave-U-Net") mode: decimation down,
    linear interpolation up, and a final 1x1 over the output and the input
  * a 2-layer BiLSTM bottleneck + linear projection
  * the decoder (deepest first): add the center-trimmed skip, the rewrite
    conv (context 3) + GLU, ConvTranspose1d(k=8, s=4), ReLU but on the
    output layer
  * the output center-trimmed to the input length
  * at a fresh init, every conv's weight and bias divided by
    sqrt(std(weight) / RESCALE), as upstream rescales its init with its
    default of 0.1 (the JAX package does not rescale)

The published configuration (channels 80, depth 6) has a 2,560-channel
bottom and 415.09 M params (1.66 GB in fp32).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sudo_rm_rf_tpu_torch.models.baselines.layers import Linear, torch_lstm
from sudo_rm_rf_tpu_torch.models.layers import (
    Conv1d,
    ConvTranspose1d,
    default_generator,
    kaiming_uniform_conv,
)


def center_trim(x: torch.Tensor, length: int) -> torch.Tensor:
    """The middle ``length`` samples of the last dim (the extra on the right
    when it is odd)."""
    delta = x.shape[-1] - length
    if delta < 0:
        raise ValueError(f"tensor must be larger than reference, delta={delta}")
    if delta:
        return x[..., delta // 2: -(delta - delta // 2)]
    return x


def linear_upsample(x: torch.Tensor, stride: int) -> torch.Tensor:
    """Linear interpolation by ``stride``: length (T - 1) * stride."""
    b, c, _ = x.shape
    w = torch.arange(stride, dtype=x.dtype, device=x.device) / stride
    out = x[..., :-1, None] * (1 - w) + x[..., 1:, None] * w
    return out.reshape(b, c, -1)


class BLSTM(nn.Module):
    """A bidirectional LSTM over (B, C, T), projected back to C."""

    def __init__(self, dim: int, layers: int = 1, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        g = default_generator(generator)
        self.lstm = torch_lstm(dim, dim, num_layers=layers, bidirectional=True, generator=g,
                               device=device)
        self.linear = Linear(2 * dim, dim, generator=g, device=device)

    def forward(self, x):
        return self.linear(self.lstm(x.transpose(1, 2))[0]).transpose(1, 2)


RESCALE = 0.1


def rescale_convs(module: nn.Module, reference: float) -> None:
    """Divide each conv's weight and bias by sqrt(std(weight) / reference)."""
    with torch.no_grad():
        for sub in module.modules():
            if isinstance(sub, (Conv1d, ConvTranspose1d)):
                scale = (sub.weight.std() / reference).sqrt()
                sub.weight.div_(scale)
                if sub.bias is not None:
                    sub.bias.div_(scale)


class Demucs(nn.Module):
    """Input (B, T) or (B, 1, T) -> (B, sources, T)."""

    def __init__(self, sources: int = 2, audio_channels: int = 1, channels: int = 80,
                 depth: int = 6, rewrite: bool = True, glu: bool = True,
                 upsample: bool = False, kernel_size: int = 8, stride: int = 4,
                 growth: float = 2.0, lstm_layers: int = 2, context: int = 3, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        g = default_generator(generator)
        self.sources, self.audio_channels = sources, audio_channels
        self.upsample, self.stride, self.lstm_layers = upsample, stride, lstm_layers
        ch_scale = 2 if glu else 1
        act = functools.partial(nn.GLU, dim=1) if glu else nn.ReLU
        enc_stride = 1 if upsample else stride

        self.encoder = nn.ModuleList()
        decoders = []
        in_ch, ch = audio_channels, channels
        for index in range(depth):
            layers = [Conv1d(in_ch, ch, kernel_size, stride=enc_stride, generator=g,
                             device=device), nn.ReLU()]
            if rewrite:
                layers += [Conv1d(ch, ch_scale * ch, 1, generator=g, device=device), act()]
            self.encoder.append(nn.Sequential(*layers))
            if index > 0:
                out_ch = in_ch
            elif upsample:
                out_ch = channels
            else:
                out_ch = sources * audio_channels
            layers = []
            if rewrite:
                layers += [Conv1d(ch, ch_scale * ch, context, generator=g, device=device),
                           act()]
            if upsample:
                layers.append(Conv1d(ch, out_ch, kernel_size, generator=g, device=device))
            else:
                layers.append(ConvTranspose1d(ch, out_ch, kernel_size, stride=stride,
                                              use_bias=True, weight_init=kaiming_uniform_conv,
                                              generator=g, device=device))
            if index > 0:
                layers.append(nn.ReLU())
            decoders.insert(0, nn.Sequential(*layers))
            in_ch, ch = ch, int(growth * ch)
        self.decoder = nn.ModuleList(decoders)
        if lstm_layers:
            self.lstm = BLSTM(in_ch, lstm_layers, generator=g, device=device)
        if upsample:
            self.final = Conv1d(channels + audio_channels, sources * audio_channels, 1,
                                generator=g, device=device)
        if RESCALE:
            rescale_convs(self, RESCALE)

    def forward(self, mix):
        if mix.ndim == 3:
            mix = mix[:, 0, :]
        in_len = mix.shape[-1]
        x = F.pad(mix[:, None, :], (7210, 7210))
        saved = [x]
        for encode in self.encoder:
            x = encode(x)
            saved.append(x)
            if self.upsample:
                x = x[:, :, ::self.stride]
        if self.lstm_layers:
            x = self.lstm(x)
        for decode in self.decoder:
            if self.upsample:
                x = linear_upsample(x, self.stride)
            x = decode(x + center_trim(saved.pop(-1), x.shape[-1]))
        if self.upsample:
            x = self.final(torch.cat([x, center_trim(saved.pop(-1), x.shape[-1])], dim=1))
        x = x.reshape(x.shape[0], self.sources, x.shape[-1])
        return center_trim(x, in_len)
