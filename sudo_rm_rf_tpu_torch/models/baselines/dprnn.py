"""DPRNN baseline (dual-path BiLSTM over segmented chunks), counterpart of
``sudo_rm_rf_tpu/models/baselines/dprnn.py``.

  * encoder Conv1d(1 -> E, win, stride win//2, bias-free) + ReLU
  * GroupNorm(1) over the encoder output; the separator: a bias-free 1x1
    bottleneck -> 50%-overlapped chunks -> ``layer`` dual-path blocks
    (intra-chunk BiLSTM, inter-chunk BiLSTM, each projected back, GroupNorm'd
    and added) -> PReLU + 1x1 Conv2d to nspk * N -> overlap-add merge ->
    gated tanh / sigmoid output
  * a bias-free 1x1 mask conv -> ReLU -> a linear basis decoder and
    overlap-add

The LSTMs are ``nn.LSTM(batch_first=True)``, torch's own layout, which the
JAX package's ``TorchLSTM`` mirrors (its scan runs the reverse direction over
the reversed sequence), so the param names load strictly either way. On a
card they are cuDNN's LSTM, a library call: JAX runs them outside any Pallas
kernel too.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sudo_rm_rf_tpu_torch import ops
from sudo_rm_rf_tpu_torch.models.baselines.layers import Conv2d1x1, Linear, torch_lstm
from sudo_rm_rf_tpu_torch.models.layers import Conv1d, PReLU, default_generator
from sudo_rm_rf_tpu_torch.models.sudormrf import GroupNorm1


class SingleRNN(nn.Module):
    """An LSTM over (B, T, C), projected back to C by a linear layer."""

    def __init__(self, input_size: int, hidden_size: int, bidirectional: bool = False, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        g = default_generator(generator)
        ndir = 2 if bidirectional else 1
        self.rnn = torch_lstm(input_size, hidden_size, bidirectional=bidirectional,
                              generator=g, device=device)
        self.proj = Linear(hidden_size * ndir, input_size, generator=g, device=device)

    def forward(self, x):
        return self.proj(self.rnn(x)[0])


class DPRNNCore(nn.Module):
    """Stacked dual-path blocks over (B, N, dim1, dim2)."""

    def __init__(self, input_size: int, hidden_size: int, output_size: int,
                 num_layers: int = 1, bidirectional: bool = True, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        g = default_generator(generator)
        self.row_rnn = nn.ModuleList(
            SingleRNN(input_size, hidden_size, True, generator=g, device=device)
            for _ in range(num_layers))
        self.col_rnn = nn.ModuleList(
            SingleRNN(input_size, hidden_size, bidirectional, generator=g, device=device)
            for _ in range(num_layers))
        self.row_norm = nn.ModuleList(GroupNorm1(input_size, device=device)
                                      for _ in range(num_layers))
        self.col_norm = nn.ModuleList(GroupNorm1(input_size, device=device)
                                      for _ in range(num_layers))
        self.output = nn.Sequential(PReLU(device=device),
                                    Conv2d1x1(input_size, output_size, generator=g,
                                              device=device))

    def forward(self, x):
        b, n, dim1, dim2 = x.shape
        out = x
        for row_rnn, row_norm, col_rnn, col_norm in zip(self.row_rnn, self.row_norm,
                                                        self.col_rnn, self.col_norm):
            # intra-chunk: sequences along dim1, batched over dim2
            row = row_rnn(out.permute(0, 3, 2, 1).reshape(b * dim2, dim1, n))
            out = out + row_norm(row.reshape(b, dim2, dim1, n).permute(0, 3, 2, 1))
            # inter-chunk: sequences along dim2, batched over dim1
            col = col_rnn(out.permute(0, 2, 3, 1).reshape(b * dim1, dim2, n))
            out = out + col_norm(col.reshape(b, dim1, dim2, n).permute(0, 3, 1, 2))
        return self.output(out)


def split_feature(x: torch.Tensor, segment_size: int):
    """(B, N, T) -> ((B, N, segment_size, K) 50%-overlapped chunks, the
    right padding ``rest``)."""
    b, n, t = x.shape
    stride = segment_size // 2
    rest = segment_size - (stride + t % segment_size) % segment_size
    x = F.pad(x, (stride, rest + stride))
    seg1 = x[:, :, :-stride].reshape(b, n, -1, segment_size)
    seg2 = x[:, :, stride:].reshape(b, n, -1, segment_size)
    segs = torch.cat([seg1, seg2], dim=3).reshape(b, n, -1, segment_size)
    return segs.transpose(2, 3), rest


def merge_feature(x: torch.Tensor, rest: int) -> torch.Tensor:
    """The inverse of :func:`split_feature`: (B, N, segment_size, K) -> (B,
    N, T), the overlapping halves added."""
    b, n, segment_size, _ = x.shape
    stride = segment_size // 2
    x = x.transpose(2, 3).reshape(b, n, -1, segment_size * 2)
    x1 = x[:, :, :, :segment_size].reshape(b, n, -1)[:, :, stride:]
    x2 = x[:, :, :, segment_size:].reshape(b, n, -1)[:, :, :-stride]
    out = x1 + x2
    return out[:, :, :-rest] if rest > 0 else out


class BFModule(nn.Module):
    """The separator: bottleneck -> split -> DPRNN -> merge -> gated output,
    (B, E, T) -> (B, nspk, T, N)."""

    def __init__(self, input_dim: int, feature_dim: int, hidden_dim: int, num_spk: int = 2,
                 layer: int = 4, segment_size: int = 100, bidirectional: bool = True, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        g = default_generator(generator)
        self.feature_dim, self.num_spk, self.segment_size = feature_dim, num_spk, segment_size
        self.BN = Conv1d(input_dim, feature_dim, 1, use_bias=False, generator=g,
                         device=device)
        self.DPRNN = DPRNNCore(feature_dim, hidden_dim, feature_dim * num_spk,
                               num_layers=layer, bidirectional=bidirectional, generator=g,
                               device=device)
        self.output = nn.Sequential(
            Conv1d(feature_dim, feature_dim, 1, generator=g, device=device), nn.Tanh())
        self.output_gate = nn.Sequential(
            Conv1d(feature_dim, feature_dim, 1, generator=g, device=device), nn.Sigmoid())

    def forward(self, x):
        b = x.shape[0]
        segs, rest = split_feature(self.BN(x), self.segment_size)
        out = self.DPRNN(segs).reshape(b * self.num_spk, self.feature_dim,
                                       self.segment_size, -1)
        out = merge_feature(out, rest)  # (B * nspk, N, T)
        bf = self.output(out) * self.output_gate(out)
        return bf.transpose(1, 2).reshape(b, self.num_spk, -1, self.feature_dim)


class Encoder(nn.Module):
    """Conv1d + ReLU front end."""

    def __init__(self, win: int, enc_dim: int, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.conv1d_U = Conv1d(1, enc_dim, win, stride=win // 2, use_bias=False,
                               generator=generator, device=device)

    def forward(self, x):  # (B, 1, T)
        return torch.relu(self.conv1d_U(x))


class Decoder(nn.Module):
    """A linear basis decoder and overlap-add."""

    def __init__(self, enc_dim: int, win: int, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.win = win
        self.basis_signals = Linear(enc_dim, win, use_bias=False, generator=generator,
                                    device=device)

    def forward(self, mixture_w, est_mask):
        source_w = (mixture_w[:, None, :, :] * est_mask).transpose(2, 3)  # (B, C, L, E)
        return ops.overlap_and_add(self.basis_signals(source_w), self.win // 2)


class DPRNN(nn.Module):
    """The FaSNet_base wrapper. Input (B, T) or (B, 1, T), output (B, nspk,
    T). Defaults: the published configuration (enc 256, feature 64, hidden
    128, 6 layers, segment 250; 2.63 M params)."""

    def __init__(self, enc_dim: int = 256, feature_dim: int = 64, hidden_dim: int = 128,
                 layer: int = 6, segment_size: int = 250, nspk: int = 2, win_len: int = 2,
                 *, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        g = default_generator(generator)
        self.enc_dim, self.feature_dim, self.nspk = enc_dim, feature_dim, nspk
        self.encoder = Encoder(win_len, enc_dim, generator=g, device=device)
        self.enc_LN = GroupNorm1(enc_dim, device=device)
        self.separator = BFModule(enc_dim, feature_dim, hidden_dim, nspk, layer, segment_size,
                                  generator=g, device=device)
        self.mask_conv1x1 = Conv1d(feature_dim, enc_dim, 1, use_bias=False, generator=g,
                                   device=device)
        self.decoder = Decoder(enc_dim, win_len, generator=g, device=device)

    def forward(self, x):
        if x.ndim == 3:
            x = x[:, 0, :]
        b = x.shape[0]
        mixture_w = self.encoder(x[:, None, :])  # (B, E, L)
        score = self.separator(self.enc_LN(mixture_w))  # (B, nspk, T, N)
        score = score.reshape(b * self.nspk, -1, self.feature_dim).transpose(1, 2)
        est_mask = torch.relu(self.mask_conv1x1(score).reshape(b, self.nspk, self.enc_dim, -1))
        return self.decoder(mixture_w, est_mask)
