"""SepFormer baseline (the dual-path transformer vendored from
SpeechBrain), counterpart of ``sudo_rm_rf_tpu/models/baselines/sepformer.py``.

  * encoder Conv1d(1 -> N, k, stride k//2, bias-free) + ReLU
  * the masknet: GroupNorm(1) -> a bias-free 1x1 -> 50%-overlapped chunks ->
    ``masknet_numlayers`` dual-computation blocks (an intra-chunk and an
    inter-chunk block, each normed and added) -> PReLU -> Conv2d to spks * N
    -> overlap-add -> gated tanh / sigmoid -> a bias-free 1x1 -> ReLU
  * the published block is SpeechBrain's transformer encoder: pre- or
    post-norm multi-head attention and a position-wise FFN, LayerNorm eps
    1e-6, with the sinusoidal encoding added once at the block input
  * the decoder: one shared bias-free ConvTranspose1d per source, the output
    padded or cut to the input length

Every dual-path block family of the JAX file is here, selected by
``{intra,inter}_block_type``: 'transformer' (the published one), 'rnn'
(``SBRNNBlock``), 'dptnet' (``DPTNetBlock``), 'pytorch'
(``PytorchTransformerBlock``) and 'fast' (``FastTransformerBlock``). Where
upstream is broken (``SBRNNBlock`` names a symbol it never imports;
``FastTransformerBlock`` needs a library upstream does not list;
``masknet_useextralinearlayer=True`` calls ``nn.Linear`` wrongly; the
DPTNet and plain-pytorch blocks run seq-first layers on batch-first
tensors) the JAX package implements the evident intent, and so does the
port. Dropout is 0, as upstream's default.

``scan_layers`` (the JAX package's one ``lax.scan`` over each encoder's
stacked layers, a compile-size device) is accepted and changes nothing: the
layers are a plain loop over ``layers.{j}``, and ``convert.load_jax_params``
reads the JAX scan layout (``layers_scan/layer`` inside every encoder) as
well as the unrolled one.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sudo_rm_rf_tpu_torch.models.attentive import TorchMHA, sinusoidal_pe
from sudo_rm_rf_tpu_torch.models.baselines.dprnn import merge_feature, split_feature
from sudo_rm_rf_tpu_torch.models.baselines.layers import Conv2d1x1, Linear, torch_lstm
from sudo_rm_rf_tpu_torch.models.layers import (
    Conv1d,
    ConvTranspose1d,
    PReLU,
    default_generator,
    kaiming_uniform_conv,
)
from sudo_rm_rf_tpu_torch.models.sudormrf import GroupNorm1

BLOCK_TYPES = ("transformer", "rnn", "dptnet", "pytorch", "fast")


def _add_pe(x):
    return x + sinusoidal_pe(x.shape[1], x.shape[2], x.device, x.dtype)[None]


class LayerNormLast(nn.Module):
    """SpeechBrain's LayerNorm wrapper: a ``norm`` child, eps 1e-6."""

    def __init__(self, dim: int, eps: float = 1e-6, *, device=None):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps, device=device)

    def forward(self, x):
        return self.norm(x)


class _SBMHA(nn.Module):
    """SpeechBrain's MultiheadAttention wrapper: an ``att`` child."""

    def __init__(self, d_model: int, nhead: int, *, generator=None, device=None):
        super().__init__()
        self.att = TorchMHA(d_model, nhead, generator=generator, device=device)

    def forward(self, x):
        return self.att(x)


class _PosFFN(nn.Module):
    """PositionalwiseFeedForward: ``ffn.{0,3}`` linears around a ReLU."""

    def __init__(self, d_model: int, d_ffn: int, *, generator=None, device=None):
        super().__init__()
        g = default_generator(generator)
        self.ffn = nn.Sequential(Linear(d_model, d_ffn, generator=g, device=device), nn.ReLU(),
                                 nn.Identity(), Linear(d_ffn, d_model, generator=g,
                                                       device=device))

    def forward(self, x):
        return self.ffn(x)


class TransformerEncoderLayer(nn.Module):
    """SpeechBrain's encoder layer (regular MHA), channels last (B, L, C)."""

    def __init__(self, d_ffn: int, nhead: int, d_model: int, normalize_before: bool = False,
                 *, generator=None, device=None):
        super().__init__()
        g = default_generator(generator)
        self.normalize_before = normalize_before
        self.self_att = _SBMHA(d_model, nhead, generator=g, device=device)
        self.pos_ffn = _PosFFN(d_model, d_ffn, generator=g, device=device)
        self.norm1 = LayerNormLast(d_model, device=device)
        self.norm2 = LayerNormLast(d_model, device=device)

    def forward(self, src):
        pre = self.normalize_before
        src = src + self.self_att(self.norm1(src) if pre else src)
        if not pre:
            src = self.norm1(src)
        out = src + self.pos_ffn(self.norm2(src) if pre else src)
        return out if pre else self.norm2(out)


class _TransformerEncoder(nn.Module):
    """SpeechBrain's TransformerEncoder: ``layers.{j}`` and a final norm."""

    def __init__(self, num_layers: int, d_model: int, nhead: int, d_ffn: int,
                 norm_before: bool = False, *, generator=None, device=None):
        super().__init__()
        g = default_generator(generator)
        self.layers = nn.Sequential(*(
            TransformerEncoderLayer(d_ffn, nhead, d_model, normalize_before=norm_before,
                                    generator=g, device=device)
            for _ in range(num_layers)))
        self.norm = LayerNormLast(d_model, device=device)

    def forward(self, x):
        return self.norm(self.layers(x))


class SBTransformerBlock(nn.Module):
    """The published dual-path block: the positional encoding added once,
    then the encoder under ``mdl``. (B, L, C) -> (B, L, C)."""

    def __init__(self, num_layers: int, d_model: int, nhead: int, d_ffn: int = 2048,
                 use_positional_encoding: bool = False, norm_before: bool = False,
                 scan_layers: bool = False, *, generator=None, device=None):
        super().__init__()
        self.use_positional_encoding = use_positional_encoding
        self.out_dim = d_model
        self.mdl = _TransformerEncoder(num_layers, d_model, nhead, d_ffn,
                                       norm_before=norm_before, generator=generator,
                                       device=device)

    def forward(self, x):
        return self.mdl(_add_pe(x) if self.use_positional_encoding else x)


class _SBRNNWrapper(nn.Module):
    """SpeechBrain's RNN lobe naming: the torch LSTM under ``rnn``."""

    def __init__(self, input_size: int, hidden_channels: int, num_layers: int,
                 bidirectional: bool, *, generator=None, device=None):
        super().__init__()
        self.rnn = torch_lstm(input_size, hidden_channels, num_layers, bidirectional,
                              generator=generator, device=device)

    def forward(self, x):
        return self.rnn(x)[0]


class SBRNNBlock(nn.Module):
    """The RNN dual-path block, as its evident intent (upstream names an
    ``SBRNN`` it never imports): a bidirectional LSTM over (B, L, N)
    returning the raw (B, L, 2H) states."""

    def __init__(self, input_size: int, hidden_channels: int, num_layers: int = 1,
                 bidirectional: bool = True, *, generator=None, device=None):
        super().__init__()
        self.out_dim = hidden_channels * (2 if bidirectional else 1)
        self.mdl = _SBRNNWrapper(input_size, hidden_channels, num_layers, bidirectional,
                                 generator=generator, device=device)

    def forward(self, x):
        return self.mdl(x)


class DPTNetBlock(nn.Module):
    """The DPTNet dual-path block over (B, L, N): post-norm MHA, then a
    bidirectional LSTM "feed-forward" (d_model -> 2 d_model a direction) +
    ReLU + a linear back to d_model, both with residuals, LayerNorm eps
    1e-5. Upstream runs seq-first layers on batch-first tensors; this is the
    per-sequence intent, as in the JAX package."""

    def __init__(self, d_model: int, nhead: int, *, generator=None, device=None):
        super().__init__()
        g = default_generator(generator)
        self.out_dim = d_model
        self.self_attn = TorchMHA(d_model, nhead, generator=g, device=device)
        self.norm1 = nn.LayerNorm(d_model, device=device)
        self.rnn = torch_lstm(d_model, d_model * 2, bidirectional=True, generator=g,
                              device=device)
        self.linear2 = Linear(d_model * 4, d_model, generator=g, device=device)
        self.norm2 = nn.LayerNorm(d_model, device=device)

    def forward(self, src):
        src = self.norm1(src + self.self_attn(src))
        return self.norm2(src + self.linear2(torch.relu(self.rnn(src)[0])))


class _PytorchEncoderLayer(nn.Module):
    """torch ``nn.TransformerEncoderLayer`` (post-norm, ReLU, eval mode)."""

    def __init__(self, d_model: int, nhead: int, d_ffn: int, *, generator=None, device=None):
        super().__init__()
        g = default_generator(generator)
        self.self_attn = TorchMHA(d_model, nhead, generator=g, device=device)
        self.norm1 = nn.LayerNorm(d_model, device=device)
        self.linear1 = Linear(d_model, d_ffn, generator=g, device=device)
        self.linear2 = Linear(d_ffn, d_model, generator=g, device=device)
        self.norm2 = nn.LayerNorm(d_model, device=device)

    def forward(self, src):
        src = self.norm1(src + self.self_attn(src))
        return self.norm2(src + self.linear2(torch.relu(self.linear1(src))))


class _PytorchEncoderStack(nn.Module):
    """torch ``nn.TransformerEncoder(norm=None)``: ``layers.{i}``."""

    def __init__(self, d_model: int, nhead: int, d_ffn: int, num_layers: int, *,
                 generator=None, device=None):
        super().__init__()
        g = default_generator(generator)
        self.layers = nn.Sequential(*(
            _PytorchEncoderLayer(d_model, nhead, d_ffn, generator=g, device=device)
            for _ in range(num_layers)))

    def forward(self, x):
        return self.layers(x)


class PytorchTransformerBlock(nn.Module):
    """The plain-pytorch dual-path block over (B, L, N), per sequence (the
    intent of upstream's seq-first wrapper), the encoding added over L."""

    def __init__(self, out_channels: int, num_layers: int = 6, nhead: int = 8,
                 d_ffn: int = 2048, use_positional_encoding: bool = True, *,
                 generator=None, device=None):
        super().__init__()
        self.out_dim = out_channels
        self.use_positional_encoding = use_positional_encoding
        self.mdl = _PytorchEncoderStack(out_channels, nhead, d_ffn, num_layers,
                                        generator=generator, device=device)

    def forward(self, x):
        return self.mdl(_add_pe(x) if self.use_positional_encoding else x)


class _LinearAttention(nn.Module):
    """Linear (kernelized) attention, the 'linear' type of the library
    upstream's FastTransformerBlock builds: phi(x) = elu(x) + 1 and
    ``V' = phi(Q) (phi(K)^T V) / (phi(Q) phi(K)^T 1)``, O(L)."""

    def __init__(self, d_model: int, nhead: int, *, generator=None, device=None):
        super().__init__()
        g = default_generator(generator)
        self.nhead = nhead
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (
            Linear(d_model, d_model, generator=g, device=device) for _ in range(4))

    def forward(self, x):  # (B, L, N)
        b, length, d = x.shape
        h = self.nhead

        def heads(lin):
            return lin(x).reshape(b, length, h, d // h)

        fq, fk = F.elu(heads(self.q_proj)) + 1.0, F.elu(heads(self.k_proj)) + 1.0
        kv = torch.einsum("blhd,blhe->bhde", fk, heads(self.v_proj))
        z = 1.0 / (torch.einsum("blhd,bhd->blh", fq, fk.sum(dim=1)) + 1e-6)
        out = torch.einsum("blhd,bhde,blh->blhe", fq, kv, z).reshape(b, length, d)
        return self.out_proj(out)


class _FastEncoderLayer(nn.Module):
    """Attention residual, norm1, then linear1 -> ReLU -> linear2 residual,
    norm2 (post-norm, eps 1e-5)."""

    def __init__(self, d_model: int, nhead: int, d_ffn: int, *, generator=None, device=None):
        super().__init__()
        g = default_generator(generator)
        self.attention = _LinearAttention(d_model, nhead, generator=g, device=device)
        self.norm1 = nn.LayerNorm(d_model, device=device)
        self.linear1 = Linear(d_model, d_ffn, generator=g, device=device)
        self.linear2 = Linear(d_ffn, d_model, generator=g, device=device)
        self.norm2 = nn.LayerNorm(d_model, device=device)

    def forward(self, x):
        x = self.norm1(x + self.attention(x))
        return self.norm2(x + self.linear2(torch.relu(self.linear1(x))))


class FastTransformerBlock(nn.Module):
    """The efficient-attention dual-path block: linear attention layers;
    ``attention_type='reformer'`` zero-pads L to a multiple of twice the
    bucket size around the same stack and cuts it back, as upstream's
    wrapper does."""

    def __init__(self, out_channels: int, attention_type: str = "linear",
                 num_layers: int = 6, nhead: int = 8, d_ffn: int = 1024,
                 reformer_bucket_size: int = 32, *, generator=None, device=None):
        super().__init__()
        g = default_generator(generator)
        self.out_dim = out_channels
        self.attention_type = attention_type
        self.reformer_bucket_size = reformer_bucket_size
        self.mdl_layers = nn.Sequential(*(
            _FastEncoderLayer(out_channels, nhead, d_ffn, generator=g, device=device)
            for _ in range(num_layers)))

    def forward(self, x):
        pad = 0
        if self.attention_type == "reformer":
            bucket = self.reformer_bucket_size * 2
            pad = bucket - (x.shape[1] % bucket)
            x = F.pad(x, (0, 0, 0, pad))
        x = self.mdl_layers(x)
        return x[:, :-pad, :] if pad else x


class GlobalLayerNorm4(nn.Module):
    """SepFormer's gLN over (C, K, S) of (B, C, K, S), (C, 1, 1) params."""

    def __init__(self, dim: int, eps: float = 1e-8, *, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, 1, 1, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, 1, 1, device=device))

    def forward(self, x):
        mean = x.mean(dim=(1, 2, 3), keepdim=True)
        var = (x - mean).square().mean(dim=(1, 2, 3), keepdim=True)
        return self.weight * (x - mean) * torch.rsqrt(var + self.eps) + self.bias


_BLOCKS = {"transformer": SBTransformerBlock, "rnn": SBRNNBlock, "dptnet": DPTNetBlock,
           "pytorch": PytorchTransformerBlock, "fast": FastTransformerBlock}


def make_block(cfg: dict, generator=None, device=None) -> nn.Module:
    """A dual-path block from a config with its ``block_type``."""
    cfg = dict(cfg)
    kind = cfg.pop("block_type", "transformer")
    if kind not in _BLOCKS:
        raise ValueError(f"unknown dual-path block type {kind!r}; have {BLOCK_TYPES}")
    return _BLOCKS[kind](**cfg, generator=generator, device=device)


def _norm4(norm: str, channels: int, device):
    if norm == "ln":
        return GroupNorm1(channels, device=device)
    if norm == "gln":
        return GlobalLayerNorm4(channels, device=device)
    return None


class DualComputationBlock(nn.Module):
    """An intra-chunk then an inter-chunk block over (B, N, K, S), each with
    its optional linear and norm; the intra output skips around the inter
    block."""

    def __init__(self, out_channels: int, intra_cfg: dict, inter_cfg: dict, norm: str = "ln",
                 skip_around_intra: bool = True, linear_layer_after_inter_intra: bool = False,
                 *, generator=None, device=None):
        super().__init__()
        g = default_generator(generator)
        self.skip_around_intra = skip_around_intra
        self.intra_mdl = make_block(intra_cfg, g, device)
        self.inter_mdl = make_block(inter_cfg, g, device)
        self.extralinear = linear_layer_after_inter_intra
        for blk in (self.intra_mdl, self.inter_mdl):
            if blk.out_dim != out_channels and not self.extralinear:
                raise ValueError("RNN dual-path blocks change the feature dim; "
                                 "linear_layer_after_inter_intra must be enabled")
        if self.extralinear:
            self.intra_linear = Linear(self.intra_mdl.out_dim, out_channels, generator=g,
                                       device=device)
            self.inter_linear = Linear(self.inter_mdl.out_dim, out_channels, generator=g,
                                       device=device)
        self.intra_norm = _norm4(norm, out_channels, device)
        self.inter_norm = _norm4(norm, out_channels, device)

    def forward(self, x):  # (B, N, K, S)
        b, n, k, s = x.shape
        intra = self.intra_mdl(x.permute(0, 3, 2, 1).reshape(b * s, k, n))
        if self.extralinear:
            intra = self.intra_linear(intra)
        intra = intra.reshape(b, s, k, n).permute(0, 3, 2, 1)
        if self.intra_norm is not None:
            intra = self.intra_norm(intra)
        if self.skip_around_intra:
            intra = intra + x
        inter = self.inter_mdl(intra.permute(0, 2, 3, 1).reshape(b * k, s, n))
        if self.extralinear:
            inter = self.inter_linear(inter)
        inter = inter.reshape(b, k, s, n).permute(0, 3, 1, 2)
        if self.inter_norm is not None:
            inter = self.inter_norm(inter)
        return inter + intra


class _Encoder(nn.Module):
    """Conv + ReLU encoder, its conv under ``conv1d``."""

    def __init__(self, k: int, n: int, *, generator=None, device=None):
        super().__init__()
        self.conv1d = Conv1d(1, n, k, stride=k // 2, use_bias=False, generator=generator,
                             device=device)

    def forward(self, x):
        return torch.relu(self.conv1d(x))


class _MaskNet(nn.Module):
    """The Dual_Path_Model: (B, N, L) -> masks (spks, B, N, L)."""

    def __init__(self, n_channels: int, chunksize: int, numlayers: int, norm: str,
                 extralinear: bool, extraskip: bool, numspks: int, intra_cfg: dict,
                 inter_cfg: dict, *, generator=None, device=None):
        super().__init__()
        g = default_generator(generator)
        n = n_channels
        self.chunksize, self.numspks = chunksize, numspks
        self.norm = GroupNorm1(n, device=device)
        self.conv1d = Conv1d(n, n, 1, use_bias=False, generator=g, device=device)
        self.dual_mdl = nn.ModuleList(
            DualComputationBlock(n, intra_cfg, inter_cfg, norm=norm, skip_around_intra=extraskip,
                                 linear_layer_after_inter_intra=extralinear, generator=g,
                                 device=device)
            for _ in range(numlayers))
        self.prelu = PReLU(device=device)
        self.conv2d = Conv2d1x1(n, n * numspks, generator=g, device=device)
        self.output = nn.Sequential(Conv1d(n, n, 1, generator=g, device=device), nn.Tanh())
        self.output_gate = nn.Sequential(Conv1d(n, n, 1, generator=g, device=device),
                                         nn.Sigmoid())
        self.end_conv1x1 = Conv1d(n, n, 1, use_bias=False, generator=g, device=device)

    def forward(self, x):
        x = self.conv1d(self.norm(x))
        x, gap = split_feature(x, self.chunksize)
        for block in self.dual_mdl:
            x = block(x)
        x = self.conv2d(self.prelu(x))
        b, n2, k, s = x.shape
        n = n2 // self.numspks
        x = merge_feature(x.reshape(b * self.numspks, n, k, s), gap)
        x = self.end_conv1x1(self.output(x) * self.output_gate(x))
        return torch.relu(x.reshape(b, self.numspks, n, -1)).transpose(0, 1)


class SepFormer(nn.Module):
    """The SepformerWrapper. Input (B, T) or (B, 1, T), output (B, spks, T).
    Defaults: the published configuration (N 256, kernel 16, chunk 250, 2
    dual blocks of 8 intra and 8 inter layers, 8 heads, d_ffn 1024; 25.68 M
    params)."""

    def __init__(self, encoder_kernel_size: int = 16, encoder_in_nchannels: int = 1,
                 encoder_out_nchannels: int = 256, masknet_chunksize: int = 250,
                 masknet_numlayers: int = 2, masknet_norm: str = "ln",
                 masknet_useextralinearlayer: bool = False,
                 masknet_extraskipconnection: bool = True, masknet_numspks: int = 2,
                 intra_numlayers: int = 8, inter_numlayers: int = 8, intra_nhead: int = 8,
                 inter_nhead: int = 8, intra_dffn: int = 1024, inter_dffn: int = 1024,
                 intra_use_positional: bool = True, inter_use_positional: bool = True,
                 intra_norm_before: bool = True, inter_norm_before: bool = True,
                 intra_block_type: str = "transformer", inter_block_type: str = "transformer",
                 rnn_hidden: int = 256, scan_layers: bool = False, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        g = default_generator(generator)
        hp = dict(locals())
        self.scan_layers = scan_layers
        self.numspks = masknet_numspks
        n, k = encoder_out_nchannels, encoder_kernel_size
        self.encoder = _Encoder(k, n, generator=g, device=device)
        self.masknet = _MaskNet(
            n_channels=n, chunksize=masknet_chunksize, numlayers=masknet_numlayers,
            norm=masknet_norm, extralinear=masknet_useextralinearlayer,
            extraskip=masknet_extraskipconnection, numspks=masknet_numspks,
            intra_cfg=_block_cfg(hp, "intra"), inter_cfg=_block_cfg(hp, "inter"),
            generator=g, device=device)
        self.decoder = ConvTranspose1d(n, encoder_in_nchannels, k, stride=k // 2,
                                       weight_init=kaiming_uniform_conv, generator=g,
                                       device=device)

    def forward(self, mix):
        if mix.ndim == 3:
            mix = mix[:, 0, :]
        t_origin = mix.shape[-1]
        mix_w = self.encoder(mix[:, None, :])
        sep_h = mix_w[None] * self.masknet(mix_w)  # (spks, B, N, L)
        b, n = mix_w.shape[0], mix_w.shape[1]
        est = self.decoder(sep_h.reshape(self.numspks * b, n, -1))[:, 0, :]
        est = est.reshape(self.numspks, b, -1).transpose(0, 1)  # (B, spks, T_est)
        t_est = est.shape[-1]
        if t_origin > t_est:
            return F.pad(est, (0, t_origin - t_est))
        return est[:, :, :t_origin]


def _block_cfg(hp: dict, which: str) -> dict:
    """The block config of the ``which`` ('intra' or 'inter') blocks."""
    kind = hp[f"{which}_block_type"]
    n = hp["encoder_out_nchannels"]
    layers, nhead, dffn = (hp[f"{which}_{k}"] for k in ("numlayers", "nhead", "dffn"))
    if kind == "transformer":
        return dict(block_type=kind, num_layers=layers, d_model=n, nhead=nhead, d_ffn=dffn,
                    use_positional_encoding=hp[f"{which}_use_positional"],
                    norm_before=hp[f"{which}_norm_before"], scan_layers=hp["scan_layers"])
    if kind == "rnn":
        return dict(block_type=kind, input_size=n, hidden_channels=hp["rnn_hidden"],
                    num_layers=layers)
    if kind in ("pytorch", "fast"):
        return dict(block_type=kind, out_channels=n, num_layers=layers, nhead=nhead,
                    d_ffn=dffn)
    return dict(block_type=kind, d_model=n, nhead=nhead)
