"""Attentive SuDoRM-RF v1-v3, counterpart of
``sudo_rm_rf_tpu/models/attentive.py``.

  * v1: a U-ConvBlock whose deepest level goes through a torch
    ``nn.MultiheadAttention``-style layer (``MHANormLayer``), with the
    ``in_linear``/``out_linear`` that the upstream forward uses (they are
    commented out of the upstream ``__init__``; the JAX package restores
    them too)
  * v2: the same placement, with a hand-rolled einsum multi-head attention
    inside a ``TransformerLayer``
  * v3: the additive upsampling ladder replaced by cross-attention
    resamplers, query = the shallower level, key/value = the deeper one
  * the outer models share the improved skeleton but pad by the v1 LCM
    rule; v2 and v3 hardcode 4 heads, 256 attention dims and dropout 0.1 in
    their blocks, whatever the constructor says

Attention is the plain matmul and softmax of the JAX code. The sinusoidal
positional encodings are computed per length and device (cached), never
stored as a ``pe`` buffer, so no ``pe`` key is in ``state_dict()``.

Dropout is deterministic unless the module is in train mode *and* a
``torch.Generator`` was attached with :func:`set_dropout_generator`; its
masks come from that generator only, never from the global RNG.
``scan_blocks`` (a compile-size device of JAX's: one ``lax.scan`` over
stacked block params) is accepted and changes nothing here: the blocks are a
plain loop over ``sm.{i}``, and ``convert.load_jax_params`` reads the JAX
scan layout (``sm_scan/block``) as well as the unrolled one.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sudo_rm_rf_tpu_torch import ops
from sudo_rm_rf_tpu_torch.models.groupcomm_sudormrf import Linear
from sudo_rm_rf_tpu_torch.models.layers import (
    Conv1d,
    ConvNormAct,
    ConvTranspose1d,
    DilatedConvNorm,
    GlobLN,
    NormAct,
    PReLU,
    _uniform,
    default_generator,
    xavier_uniform_conv,
)

VARIANTS = ("v1", "v2", "v3")


@functools.lru_cache(maxsize=64)
def _pe(length: int, d_model: int, device: torch.device, dtype: torch.dtype):
    # in numpy float32, as the JAX package computes it, then cached on the device
    position = np.arange(length, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                      * (-math.log(10000.0) / d_model))
    pe = np.zeros((length, d_model), np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term[: pe[:, 1::2].shape[1]])
    with torch.inference_mode(False):
        return torch.from_numpy(pe).to(device=device, dtype=dtype)


def sinusoidal_pe(length: int, d_model: int, device=None,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The classic transformer positional encoding, (length, d_model)."""
    return _pe(length, d_model, torch.device(device or "cpu"), dtype)


class Dropout(nn.Module):
    """``where(mask, x / keep, 0)`` with mask ~ Bernoulli(keep) drawn from
    the attached generator, in train mode only."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x):
        if not self.training or self.rate == 0.0 or self.generator is None:
            return x
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=self.generator, device=x.device) < keep
        return torch.where(mask, x / keep, 0.0)


def set_dropout_generator(model: nn.Module, generator: Optional[torch.Generator]) -> int:
    """Attach ``generator`` (on the model's device) to every ``Dropout`` of
    ``model``, or detach with None; returns how many there are."""
    mods = [m for m in model.modules() if isinstance(m, Dropout)]
    for m in mods:
        m.generator = generator
    return len(mods)


def _attend(q, k, v, drop: Dropout):
    """softmax(q k^T) v over heads: q (B, L, H, D) already scaled, k and v
    (B, S, H, D) -> (B, L, H*D)."""
    logits = torch.einsum("nlhd,nshd->nhls", q, k)
    attn = drop(torch.softmax(logits, dim=-1))
    out = torch.einsum("nhls,nshd->nlhd", attn, v)
    return out.reshape(out.shape[0], out.shape[1], -1)


class MHAttentionLayer(nn.Module):
    """Hand-rolled einsum multi-head attention on channel-last (B, len, emb)
    inputs."""

    def __init__(self, emb_dim: int, d_model: int, n_heads: int, dropout: float = 0.0, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        g = default_generator(generator)
        self.d_model, self.n_heads = d_model, n_heads
        self.Q_proj = Linear(emb_dim, d_model * n_heads, generator=g, device=device)
        self.K_proj = Linear(emb_dim, d_model * n_heads, generator=g, device=device)
        self.V_proj = Linear(emb_dim, d_model * n_heads, generator=g, device=device)
        self.O_proj = Linear(d_model * n_heads, emb_dim, generator=g, device=device)
        self.attn_drop = Dropout(dropout)

    def forward(self, q, k, v):
        h, d = self.n_heads, self.d_model

        def heads(lin, x):
            return F.linear(x, lin.weight, lin.bias).reshape(x.shape[0], x.shape[1], h, d)

        out = _attend((1.0 / math.sqrt(d)) * heads(self.Q_proj, q), heads(self.K_proj, k),
                      heads(self.V_proj, v), self.attn_drop)
        return F.linear(out, self.O_proj.weight, self.O_proj.bias)


class TransformerLayer(nn.Module):
    """Self-attention + 1x1-conv FFN with GlobLNs. Input/output (B, C, T)."""

    def __init__(self, emb_dim: int, d_model: int, n_heads: int, dropout: float = 0.1, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        g = default_generator(generator)
        self.emb_dim = emb_dim
        self.pe_drop = Dropout(dropout)
        self.mha = MHAttentionLayer(emb_dim, d_model, n_heads, dropout=0.0, generator=g,
                                    device=device)
        self.out_mha_norm = GlobLN(emb_dim, device=device)
        self.ffn = ConvNormAct(emb_dim, emb_dim, 1, generator=g, device=device)
        self.out_norm = GlobLN(emb_dim, device=device)

    def forward(self, x):
        xt = x.transpose(1, 2)  # (B, T, C)
        xt = self.pe_drop(xt + sinusoidal_pe(xt.shape[1], self.emb_dim, xt.device, xt.dtype))
        xt = xt + self.mha(xt, xt, xt)
        y = self.out_mha_norm(xt.transpose(1, 2))
        return self.out_norm(self.ffn(y) + y)


class ConditionalTransformerLayer(TransformerLayer):
    """Cross-attention resampler: q = the shallow level, k/v = the deep
    level. Inputs and output (B, C, T)."""

    def forward(self, q, v):
        vt = v.transpose(1, 2)
        vt = self.pe_drop(vt + sinusoidal_pe(vt.shape[1], self.emb_dim, vt.device, vt.dtype))
        qt = q.transpose(1, 2)
        qt = qt + self.mha(qt, vt, vt)
        y = self.out_mha_norm(qt.transpose(1, 2))
        return self.out_norm(self.ffn(y) + y)


class TorchMHA(nn.Module):
    """torch ``nn.MultiheadAttention`` (self-attention, batch first) with the
    packed (3d, d) ``in_proj_weight`` (xavier-uniform, zero bias), for
    checkpoint-name parity. Input/output (B, T, d)."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        g = default_generator(generator)
        d = embed_dim
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(
            _uniform((3 * d, d), math.sqrt(6.0 / (4 * d)), g).to(device))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d, device=device))
        self.out_proj = Linear(d, d, generator=g, device=device)
        self.attn_drop = Dropout(dropout)

    def forward(self, x):
        b, t, d = x.shape
        h = self.num_heads
        hd = d // h
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).split(d, dim=-1)
        out = _attend(q.reshape(b, t, h, hd) / math.sqrt(hd), k.reshape(b, t, h, hd),
                      v.reshape(b, t, h, hd), self.attn_drop)
        return F.linear(out, self.out_proj.weight, self.out_proj.bias)


class MHANormLayer(nn.Module):
    """v1's ``nn.MultiheadAttention`` layer with its in/out linears.
    Input/output (B, C, T)."""

    def __init__(self, in_dim: int, att_dim: int, num_heads: int = 4, dropout: float = 0.1,
                 *, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        g = default_generator(generator)
        self.att_dim = att_dim
        self.in_linear = Linear(in_dim, att_dim, generator=g, device=device)
        self.pe_drop = Dropout(dropout)
        self.in_norm = GlobLN(att_dim, device=device)
        self.mha = TorchMHA(att_dim, num_heads, dropout=dropout, generator=g, device=device)
        self.out_norm1 = GlobLN(att_dim, device=device)
        self.out_linear = Linear(att_dim, in_dim, generator=g, device=device)
        self.out_norm2 = GlobLN(in_dim, device=device)
        self.act = PReLU(device=device)

    def forward(self, x):
        xt = self.in_linear(x).transpose(1, 2)  # (B, T, A)
        xt = self.pe_drop(xt + sinusoidal_pe(xt.shape[1], self.att_dim, xt.device, xt.dtype))
        xt = self.in_norm(xt.transpose(1, 2)).transpose(1, 2)
        att = self.mha(xt)
        y = xt + self.out_norm1(att.transpose(1, 2)).transpose(1, 2)
        return self.act(self.out_norm2(self.out_linear(y.transpose(1, 2))))


class AttentiveUConvBlock(nn.Module):
    """U-ConvBlock with attention at its deepest level (v1, v2) or
    cross-attention resamplers in place of the upsample-sum (v3)."""

    def __init__(self, out_channels: int = 128, in_channels: int = 512,
                 upsampling_depth: int = 4, n_heads: int = 4, att_dims: int = 256,
                 att_dropout: float = 0.1, variant: str = "v2", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"variant {variant!r} not in {VARIANTS}")
        g = default_generator(generator)
        self.depth, self.variant = upsampling_depth, variant
        self.proj_1x1 = ConvNormAct(out_channels, in_channels, 1, generator=g, device=device)
        self.spp_dw = nn.ModuleList(
            DilatedConvNorm(in_channels, in_channels, kernel_size=5, stride=1 if k == 0 else 2,
                            groups=in_channels, generator=g, device=device)
            for k in range(upsampling_depth))
        if variant == "v3":
            self.attentive_resamplers = nn.ModuleList(
                ConditionalTransformerLayer(in_channels, att_dims, n_heads,
                                            dropout=att_dropout, generator=g, device=device)
                for _ in range(upsampling_depth - 1))
        elif variant == "v1":
            self.attention = MHANormLayer(in_channels, att_dims, num_heads=n_heads,
                                          dropout=att_dropout, generator=g, device=device)
        else:
            self.attention = TransformerLayer(in_channels, att_dims, n_heads,
                                              dropout=att_dropout, generator=g, device=device)
        self.final_norm = NormAct(in_channels, device=device)
        self.res_conv = Conv1d(in_channels, out_channels, 1, generator=g, device=device)

    def forward(self, x):
        residual = x
        cur = self.spp_dw[0](self.proj_1x1(x))
        pyramid = [cur]
        for k in range(1, self.depth):
            cur = self.spp_dw[k](cur)
            pyramid.append(cur)
        if self.variant == "v3":
            # resamplers from the deepest level up: q = shallower, k/v = deeper
            acc = pyramid[-1]
            for i, k in enumerate(range(self.depth - 2, -1, -1)):
                acc = self.attentive_resamplers[i](pyramid[k], acc)
        else:
            acc = self.attention(pyramid[-1])
            for k in range(self.depth - 2, -1, -1):
                acc = pyramid[k] + ops.upsample_nearest_2x(acc)
        return self.res_conv(self.final_norm(acc)) + residual


class AttentiveSuDORMRFBase(nn.Module):
    """The shared outer skeleton: improved-style front and back end, LCM
    padding, ReLU mask. Input (B, 1, T), output (B, S, T)."""

    def __init__(self, out_channels: int = 128, in_channels: int = 512,
                 num_blocks: int = 16, upsampling_depth: int = 4,
                 enc_kernel_size: int = 21, enc_num_basis: int = 512, n_heads: int = 4,
                 att_dims: int = 256, att_dropout: float = 0.1, num_sources: int = 2,
                 variant: str = "v2", hardcode_block_attention: bool = True,
                 scan_blocks: bool = False, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        g = default_generator(generator)
        self.out_channels, self.in_channels = out_channels, in_channels
        self.num_blocks, self.upsampling_depth = num_blocks, upsampling_depth
        self.enc_kernel_size, self.enc_num_basis = enc_kernel_size, enc_num_basis
        self.num_sources, self.variant = num_sources, variant
        self.scan_blocks = scan_blocks
        if hardcode_block_attention and variant in ("v2", "v3"):
            n_heads, att_dims, att_dropout = 4, 256, 0.1
        self.n_heads, self.att_dims, self.att_dropout = n_heads, att_dims, att_dropout
        half = enc_kernel_size // 2
        self.encoder = Conv1d(1, enc_num_basis, enc_kernel_size, stride=half, padding=half,
                              use_bias=False, weight_init=xavier_uniform_conv, generator=g,
                              device=device)
        self.ln = GlobLN(enc_num_basis, device=device)
        self.bottleneck = Conv1d(enc_num_basis, out_channels, 1, generator=g, device=device)
        self.sm = nn.Sequential(*(
            AttentiveUConvBlock(out_channels, in_channels, upsampling_depth, n_heads,
                                att_dims, att_dropout, variant, generator=g, device=device)
            for _ in range(num_blocks)))
        self.mask_net = nn.Sequential(
            PReLU(device=device),
            Conv1d(out_channels, num_sources * enc_num_basis, 1, generator=g, device=device))
        self.decoder = ConvTranspose1d(
            enc_num_basis * num_sources, num_sources, enc_kernel_size, stride=half,
            padding=half, output_padding=half - 1, generator=g, device=device)

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
        x = self.mask_net(self.sm(self.bottleneck(self.ln(s))))
        b = x.shape[0]
        x = torch.relu(x.reshape(b, self.num_sources, self.enc_num_basis, -1))
        x = x * s[:, None, :, :]
        est = self.decoder(x.reshape(b, self.num_sources * self.enc_num_basis, -1))
        return ops.unpad_to_length(est, in_len)


def AttentiveSuDORMRF(**kwargs):
    kwargs.setdefault("hardcode_block_attention", False)
    return AttentiveSuDORMRFBase(variant="v1", **kwargs)


def AttentiveSuDORMRFv2(**kwargs):
    return AttentiveSuDORMRFBase(variant="v2", **kwargs)


def AttentiveSuDORMRFv3(**kwargs):
    return AttentiveSuDORMRFBase(variant="v3", **kwargs)
