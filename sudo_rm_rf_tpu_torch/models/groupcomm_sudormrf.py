"""GroupComm SuDoRM-RF v2 (SuDoRM-RF++ GC), counterpart of
``sudo_rm_rf_tpu/models/groupcomm_sudormrf.py``.

  * the Improved model's front and back end, with ``in_audio_channels`` >= 1
    audio channels in and S * C_audio sources out
  * each separator block: TAC (transform-average-concatenate across the G
    channel groups) followed by one small U-ConvBlock shared across groups,
    applied with the group axis folded into the batch: (B*G, C/G, T)
  * TAC: per-group Linear(N -> 3N) + PReLU, mean over groups -> Linear +
    PReLU, concatenate -> Linear(2H -> N) + PReLU, GlobLN over each (batch,
    group) slice, residual

Submodule names are the torch reference's (``sm.0.TAC.TAC_input.0.weight``,
``sm.0.UBlock.proj_1x1.conv.weight``, ...), so a JAX param tree or a
reference ``state_dict`` loads strictly.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from sudo_rm_rf_tpu_torch import ops
from sudo_rm_rf_tpu_torch.models.improved_sudormrf import BLOCK_IMPLS, UConvBlock, run_blocks
from sudo_rm_rf_tpu_torch.models.layers import (
    Conv1d,
    ConvTranspose1d,
    GlobLN,
    PReLU,
    _uniform,
    default_generator,
    xavier_uniform_conv,
)
from sudo_rm_rf_tpu_torch.ops.tac import fused_tac, tac_plain
from sudo_rm_rf_tpu_torch.ops.uconv import EPS, dw_conv_s1, dw_conv_s2, params_from_module


class Linear(nn.Module):
    """torch.nn.Linear over the channel axis of (..., C, T) tensors: weight
    (out, in) and bias (out,), both uniform in +-1/sqrt(in)."""

    def __init__(self, in_features: int, out_features: int, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        g = default_generator(generator)
        bound = 1.0 / math.sqrt(in_features)
        self.weight = nn.Parameter(_uniform((out_features, in_features), bound, g).to(device))
        self.bias = nn.Parameter(_uniform((out_features,), bound, g).to(device))

    def forward(self, x):
        return torch.matmul(self.weight, x) + self.bias[:, None]


class TAC(nn.Module):
    """Transform-average-concatenate over groups. Input/output (B, G, N, T)."""

    def __init__(self, input_size: int, hidden_size: int, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        g = default_generator(generator)
        self.TAC_input = nn.Sequential(
            Linear(input_size, hidden_size, generator=g, device=device), PReLU(device=device))
        self.TAC_mean = nn.Sequential(
            Linear(hidden_size, hidden_size, generator=g, device=device), PReLU(device=device))
        self.TAC_output = nn.Sequential(
            Linear(2 * hidden_size, input_size, generator=g, device=device),
            PReLU(device=device))
        self.TAC_norm = GlobLN(input_size, device=device)

    def forward(self, x):
        b, g, n, t = x.shape
        y = self.TAC_input(x)  # (B, G, H, T)
        mean = self.TAC_mean(y.mean(dim=1))  # (B, H, T)
        cat = torch.cat([y, mean[:, None].expand(-1, g, -1, -1)], dim=2)
        out = self.TAC_output(cat)  # (B, G, N, T)
        out = self.TAC_norm(out.reshape(b * g, n, t))
        return x + out.reshape(b, g, n, t)


def gc_uconv_block_fma_merged(x, kp, depth: int, g: int, matmul=None):
    """GroupComm U-ConvBlock with the groups MERGED into the channel axis.

    Every elementwise and depthwise op runs on the (B, C, T) layout while
    each GlobLN's statistics stay per (batch, group); the shared 1x1
    projections run over the folded (B*G, C/G, T) view. Same values as the
    folded block. Autograd-able: the trainable GroupComm block.

    x: (B, C_out, T) with C_out = g * out_pg; kp: the shared per-group
    block params (``params_from_module`` of the UBlock). matmul: optional
    hook for the proj/res products, ``matmul(w (O, C), v (B*G, C, T))``.
    """
    mm = matmul if matmul is not None else torch.matmul
    b, c_out, t = x.shape
    out_pg = c_out // g
    in_pg = kp["proj_w"].shape[0]
    c_in = g * in_pg

    def norm_ab(v, gamma, beta):
        """GlobLN of each (batch, group) slice of the merged v (B, C_in, T')
        as a scale and shift (each (B, C_in, 1)), norm(v) = a * v + b:
        one-pass fp32 sum and sum of squares, cast back to v's dtype."""
        v32 = v.float().reshape(b, g, in_pg, -1)
        n = v32.shape[2] * v32.shape[3]
        mean = v32.sum(dim=(2, 3), keepdim=True) / n
        var = torch.clamp((v32 * v32).sum(dim=(2, 3), keepdim=True) / n - mean * mean, min=0.0)
        a = gamma.float()[None, None, :, None] * torch.rsqrt(var + EPS)
        sh = beta.float()[None, None, :, None] - a * mean
        return a.reshape(b, c_in, 1).to(v.dtype), sh.reshape(b, c_in, 1).to(v.dtype)

    # proj 1x1 (shared across groups) + per-group GlobLN + PReLU
    y = mm(kp["proj_w"], x.reshape(b * g, out_pg, t)).reshape(b, g, in_pg, t)
    y = (y + kp["proj_b"][None, None, :, None]).reshape(b, c_in, t)
    a, sh = norm_ab(y, kp["proj_g"], kp["proj_beta"])
    y = a * y + sh
    y = torch.where(y >= 0, y, kp["proj_slope"] * y)

    # depthwise ladder on merged channels: weights tiled across groups
    dw_w = kp["dw_w"].repeat(1, g, 1)  # (depth, C_in, 5)
    dw_b = kp["dw_b"].repeat(1, g)
    a = torch.ones((b, c_in, 1), dtype=y.dtype, device=y.device)
    sh = torch.zeros((b, c_in, 1), dtype=y.dtype, device=y.device)
    cur, raw, folds = y, [], []
    for k in range(depth):
        x_in = a * cur + sh
        o = (dw_conv_s1 if k == 0 else dw_conv_s2)(x_in, dw_w[k])
        o = o + dw_b[k][None, :, None]
        a, sh = norm_ab(o, kp["dw_g"][k], kp["dw_beta"][k])
        raw.append(o)
        folds.append((a, sh))
        cur = o

    a, sh = folds[-1]
    acc = a * raw[-1] + sh
    for k in range(depth - 2, -1, -1):
        a, sh = folds[k]
        acc = (a * raw[k] + sh) + ops.upsample_nearest_2x(acc)

    # final per-group GlobLN + PReLU + shared res 1x1 + residual
    a, sh = norm_ab(acc, kp["final_g"], kp["final_beta"])
    acc = a * acc + sh
    acc = torch.where(acc >= 0, acc, kp["final_slope"] * acc)
    out = mm(kp["res_w"], acc.reshape(b * g, in_pg, t)).reshape(b, g, out_pg, t)
    out = out + kp["res_b"][None, None, :, None]
    return out.reshape(b, c_out, t) + x


def _tac_fast(tac, x, matmuls=None, fused: bool = False):
    """TAC over (B, G, N, T) with a ``groupcomm_sudormrf.TAC`` module's
    params: :func:`ops.tac.tac_plain` (channel matmuls with the optional
    ``matmuls`` hooks, in x's dtype), or with ``fused`` the hand-written
    kernel :func:`ops.tac.fused_tac` (fp32 x, no hooks). Counts every call
    in ``_tac_fast.calls``, whichever computes it."""
    _tac_fast.calls += 1
    if fused:
        return fused_tac(tac, x)
    return tac_plain(tac, x, matmuls)


# TACs computed, by either form, as ``fused_uconv_block.launches`` counts K1's
_tac_fast.calls = 0


class GCUConvBlock(nn.Module):
    """TAC + the group-folded shared U-ConvBlock.

    block_impl: 'xla' (the plain TAC and U-ConvBlock), 'fma' (the
    bandwidth-shaped TAC and the group-merged multiply-add block above:
    the same params, autograd-able) or 'kernel' (the
    CUDA U-ConvBlock kernel on (B*G, C/G, T), forward only).
    """

    def __init__(self, out_channels: int = 128, in_channels: int = 512,
                 upsampling_depth: int = 4, num_group: int = 16,
                 block_impl: str = "xla", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if block_impl not in BLOCK_IMPLS:
            raise ValueError(f"block_impl {block_impl!r} not in {BLOCK_IMPLS}")
        g = default_generator(generator)
        self.num_group, self.depth, self.block_impl = num_group, upsampling_depth, block_impl
        self.TAC = TAC(out_channels // num_group, out_channels * 3 // num_group,
                       generator=g, device=device)
        self.UBlock = UConvBlock(out_channels // num_group, in_channels // num_group,
                                 upsampling_depth, block_impl, generator=g, device=device)

    def forward(self, x):
        b, n, t = x.shape
        g = self.num_group
        xg = x.reshape(b, g, n // g, t)
        if self.block_impl == "fma":
            y = _tac_fast(self.TAC, xg)
            return gc_uconv_block_fma_merged(y.reshape(b, n, t), params_from_module(self.UBlock),
                                             self.depth, g)
        y = self.TAC(xg).reshape(b * g, n // g, t)
        return self.UBlock(y).reshape(b, n, t)


class GroupCommSuDORMRF(nn.Module):
    """GroupComm SuDoRM-RF v2. Input (B, C_audio, T), output (B, S*C_audio, T).
    remat_blocks as in ``SuDORMRFImproved``."""

    def __init__(self, in_audio_channels: int = 1, out_channels: int = 256,
                 in_channels: int = 512, num_blocks: int = 16,
                 upsampling_depth: int = 5, enc_kernel_size: int = 21,
                 enc_num_basis: int = 512, num_sources: int = 2,
                 group_size: int = 16, block_impl: str = "xla",
                 remat_blocks: bool = False, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if enc_kernel_size % 2 == 0:
            raise ValueError("encoder kernel must be odd")
        if out_channels % group_size or in_channels % group_size:
            raise ValueError(f"group_size {group_size} must divide out_channels "
                             f"{out_channels} and in_channels {in_channels}")
        g = default_generator(generator)
        self.remat_blocks = remat_blocks
        self.in_audio_channels = in_audio_channels
        self.out_channels, self.in_channels = out_channels, in_channels
        self.num_blocks, self.upsampling_depth = num_blocks, upsampling_depth
        self.enc_kernel_size, self.enc_num_basis = enc_kernel_size, enc_num_basis
        self.num_sources, self.group_size = num_sources, group_size
        n_out = num_sources * in_audio_channels
        half = enc_kernel_size // 2
        self.encoder = Conv1d(in_audio_channels, enc_num_basis, enc_kernel_size,
                              stride=half, padding=half, use_bias=False,
                              weight_init=xavier_uniform_conv, generator=g, device=device)
        self.ln = GlobLN(enc_num_basis, device=device)
        self.bottleneck = Conv1d(enc_num_basis, out_channels, 1, generator=g, device=device)
        self.sm = nn.Sequential(*(
            GCUConvBlock(out_channels, in_channels, upsampling_depth, group_size,
                         block_impl, generator=g, device=device)
            for _ in range(num_blocks)
        ))
        self.mask_net = nn.Sequential(
            PReLU(device=device),
            Conv1d(out_channels, n_out * enc_num_basis, 1, generator=g, device=device),
        )
        self.decoder = ConvTranspose1d(
            enc_num_basis * n_out, n_out, enc_kernel_size, stride=half, padding=half,
            output_padding=half - 1, generator=g, device=device)

    @property
    def n_least_samples_req(self) -> int:
        return (self.enc_kernel_size // 2) * 2**self.upsampling_depth

    def forward(self, input_wav):
        if input_wav.ndim == 2:
            input_wav = input_wav[:, None, :]
        in_len = input_wav.shape[-1]
        x = ops.pad_to_multiple(input_wav, self.n_least_samples_req)
        x = self.encoder(x)
        s = x
        x = run_blocks(self.sm, self.bottleneck(self.ln(x)), self.remat_blocks)
        x = self.mask_net(x)
        b = x.shape[0]
        n_out = self.num_sources * self.in_audio_channels
        x = torch.relu(x.reshape(b, n_out, self.enc_num_basis, -1))
        x = x * s[:, None, :, :]
        est = self.decoder(x.reshape(b, n_out * self.enc_num_basis, -1))
        return ops.unpad_to_length(est, in_len)
