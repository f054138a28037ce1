"""Causal SuDoRM-RF v3, counterpart of
``sudo_rm_rf_tpu/models/causal_sudormrf.py``.

  * causality by weight masking: every conv with kernel >= 3 zeroes its
    last k//2 taps inside each forward, so a masked tap gets zero gradient
  * no norms: each block ends in ``res_conv(u) * skipinit_gain +
    residual``, with a scalar ``skipinit_gain`` that starts at 0 (a fresh
    model passes its blocks through unchanged); the reference's alpha and
    beta scales are 1 in every configuration and are left out
  * encoder kernel 2L-1 at stride L//2, bias-free, xavier init; the PReLU'd
    mask is the representation (no product with the encoder features); a
    plain bias-free transposed-conv decoder, unmasked, which gives the
    model its bounded lookahead of L//2 samples
  * input padded to a multiple of (L//2) * 2**depth, output cropped back

The JAX package constant-folds the mask multiply under jit; here it is one
elementwise launch per masked conv and forward (the encoder and the
``depth`` depthwise convs of each block), serving included, counted by
``CausalConv1d.mask_applies``. The forward carries the serving forward's
spans (``utils/tracing.py``): ``forward``, ``forward.encode``, one
``forward.block`` a block and ``forward.decode``, one a stage of
``CausalSuDORMRF.stages``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from sudo_rm_rf_tpu_torch import ops
from sudo_rm_rf_tpu_torch.models.layers import (
    Conv1d,
    ConvTranspose1d,
    PReLU,
    default_generator,
    kaiming_uniform_conv,
    xavier_uniform_conv,
)
from sudo_rm_rf_tpu_torch.utils import tracing


def causal_mask(kernel_size: int) -> torch.Tensor:
    """Ones with the last k//2 taps zeroed (k >= 3)."""
    mask = torch.ones(kernel_size)
    if kernel_size >= 3:
        mask[-(kernel_size // 2):] = 0.0
    return mask


class CausalConv1d(Conv1d):
    """Conv1d whose weight is causally masked in every forward."""

    # weight-mask multiplies of every instance, one a masked conv's forward
    mask_applies = 0

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, groups: int = 1,
                 use_bias: bool = True, weight_init: Callable = kaiming_uniform_conv, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, groups=groups, use_bias=use_bias,
                         weight_init=weight_init, generator=generator, device=device)
        self.masked = kernel_size >= 3
        # not in the state_dict: checkpoints hold the raw weight, as JAX's do
        self.register_buffer("mask", causal_mask(kernel_size).to(device), persistent=False)

    def forward(self, x):
        w = self.weight
        if self.masked:
            CausalConv1d.mask_applies += 1
            w = w * self.mask
        return ops.conv1d(x, w, self.bias, stride=self.stride, padding=self.padding,
                          groups=self.groups)


class ConvAct(nn.Module):
    """Causally masked conv + scalar PReLU; no norm."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, groups: int = 1, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.conv = CausalConv1d(in_channels, out_channels, kernel_size, stride=stride,
                                 padding=(kernel_size - 1) // 2, groups=groups,
                                 generator=generator, device=device)
        self.act = PReLU(device=device)

    def forward(self, x):
        return self.act(self.conv(x))


class CausalUConvBlock(nn.Module):
    """Norm-free U-ConvBlock (k=21 at every level) with skip-init residual
    scaling."""

    def __init__(self, out_channels: int = 128, in_channels: int = 512,
                 upsampling_depth: int = 4, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        g = default_generator(generator)
        self.depth = upsampling_depth
        self.proj_1x1 = ConvAct(out_channels, in_channels, 1, generator=g, device=device)
        self.spp_dw = nn.ModuleList(
            ConvAct(in_channels, in_channels, kernel_size=21, stride=1 if k == 0 else 2,
                    groups=in_channels, generator=g, device=device)
            for k in range(upsampling_depth))
        self.res_conv = CausalConv1d(in_channels, out_channels, 1, generator=g,
                                     device=device)
        self.skipinit_gain = nn.Parameter(torch.zeros((), device=device))

    def forward(self, x):
        residual = x
        cur = self.spp_dw[0](self.proj_1x1(x))
        pyramid = [cur]
        for k in range(1, self.depth):
            cur = self.spp_dw[k](cur)
            pyramid.append(cur)
        acc = pyramid[-1]
        for k in range(self.depth - 2, -1, -1):
            acc = pyramid[k] + ops.upsample_nearest_2x(acc)
        return self.res_conv(acc) * self.skipinit_gain + residual


class CausalSuDORMRF(nn.Module):
    """Causal SuDoRM-RF v3. Input (B, C_audio, T), output (B, S*C_audio, T)."""

    def __init__(self, in_audio_channels: int = 1, out_channels: int = 128,
                 in_channels: int = 512, num_blocks: int = 16, upsampling_depth: int = 4,
                 enc_kernel_size: int = 21, enc_num_basis: int = 512,
                 num_sources: int = 2, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if enc_kernel_size % 2 == 0:
            raise ValueError("encoder kernel must be odd")
        g = default_generator(generator)
        self.in_audio_channels = in_audio_channels
        self.out_channels, self.in_channels = out_channels, in_channels
        self.num_blocks, self.upsampling_depth = num_blocks, upsampling_depth
        self.enc_kernel_size, self.enc_num_basis = enc_kernel_size, enc_num_basis
        self.num_sources = num_sources
        n_out = num_sources * in_audio_channels
        half = enc_kernel_size // 2
        self.encoder = CausalConv1d(
            in_audio_channels, enc_num_basis, enc_kernel_size * 2 - 1, stride=half,
            padding=(enc_kernel_size * 2 - 1) // 2, use_bias=False,
            weight_init=xavier_uniform_conv, generator=g, device=device)
        self.bottleneck = CausalConv1d(enc_num_basis, out_channels, 1, generator=g,
                                       device=device)
        self.sm = nn.Sequential(*(
            CausalUConvBlock(out_channels, in_channels, upsampling_depth, generator=g,
                             device=device)
            for _ in range(num_blocks)))
        self.mask_net = nn.Sequential(
            PReLU(device=device),
            CausalConv1d(out_channels, n_out * enc_num_basis, 1, generator=g,
                         device=device))
        self.mask_nl_class = PReLU(device=device)
        self.decoder = ConvTranspose1d(
            enc_num_basis * n_out, n_out, enc_kernel_size, stride=half, padding=half,
            output_padding=half - 1, generator=g, device=device)

    @property
    def n_least_samples_req(self) -> int:
        return (self.enc_kernel_size // 2) * 2**self.upsampling_depth

    def stages(self):
        """The forward of a (B, C, T) input as (span name, callable) pairs in
        order: the encoder (pad, masked encoder, bottleneck), each block,
        and the mask head with the decoder. Composed and cropped back to T,
        they are the forward; the streaming separator captures each one as
        a CUDA graph."""
        yield "forward.encode", self._encode
        for block in self.sm:
            yield "forward.block", block
        yield "forward.decode", self._decode

    def _encode(self, x):
        x = ops.pad_to_multiple(x, self.n_least_samples_req)
        return self.bottleneck(self.encoder(x))

    def _decode(self, x):
        x = self.mask_net(x)
        b = x.shape[0]
        n_out = self.num_sources * self.in_audio_channels
        x = self.mask_nl_class(x.reshape(b, n_out, self.enc_num_basis, -1))
        return self.decoder(x.reshape(b, n_out * self.enc_num_basis, -1))

    def forward(self, input_wav):
        with tracing.span("forward", rows=input_wav.shape[0]):
            if input_wav.ndim == 2:
                input_wav = input_wav[:, None, :]
            x = input_wav
            for name, stage in self.stages():
                with tracing.span(name):
                    x = stage(x)
            return ops.unpad_to_length(x, input_wav.shape[-1])
