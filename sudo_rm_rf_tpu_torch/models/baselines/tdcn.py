"""Two-step TDCN baselines, counterparts of
``sudo_rm_rf_tpu/models/baselines/tdcn.py``: TDCN and ResidualTN.

  * TDCN: a ReLU conv front end -> GlobalLayerNorm (eps 10e-8, i.e. 1e-7, as
    upstream writes it) -> 1x1 -> R*X dilated depthwise TCN blocks (dilation
    2^d) -> an optional reshape 1x1 -> GlobalLayerNorm -> the Conv2d mask
    head, a ReLU, then softmax over sources (sigmoid for one) -> a grouped
    transposed-conv back end. No input padding or output cropping.
  * ResidualTN: the same skeleton with BatchNorm1d norms at the trunk,
    CepstralNorm (per channel over time) inside the blocks, and hardcoded
    long-range residuals into layers 8, 11, 16, 19, 24 and 27, each a 1x1
    dense over CepstralNorm'd earlier outputs (one norm per residual source,
    shared by every layer that reads it). It needs R*X >= 28; the published
    configuration is X=8, R=4.
  * The BatchNorm1d norms always normalize by ``running_mean`` and
    ``running_var``, and those are trainable params (``nn.Parameter``s
    under torch's state_dict names), as in the JAX package, where they sit
    in the ``params`` collection and Adam updates them. ``nn.BatchNorm1d``
    would use batch statistics in train mode. A reference ``.pt``'s
    ``num_batches_tracked`` is ignored on load.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sudo_rm_rf_tpu_torch.models.layers import (
    Conv1d,
    ConvTranspose1d,
    PReLU,
    default_generator,
    kaiming_uniform_conv,
)
from sudo_rm_rf_tpu_torch.models.sudormrf import MaskConv2d

# the long-range residual sources of each layer of ResidualTN (-1: the
# separation input, the bottleneck's output)
_RESIDUALS = {8: (-1,), 16: (-1, 8), 24: (-1, 8, 16), 11: (3,), 19: (3, 11),
              27: (3, 11, 19)}


class GlobalLayerNorm(nn.Module):
    """(1, C, 1)-param global LN over channels and time."""

    dims = (1, 2)

    def __init__(self, channels: int, eps: float = 10e-8, *, device=None):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(1, channels, 1, device=device))
        self.beta = nn.Parameter(torch.zeros(1, channels, 1, device=device))

    def forward(self, x):
        mean = x.mean(dim=self.dims, keepdim=True)
        var = (x - mean).square().mean(dim=self.dims, keepdim=True)
        return self.gamma * (x - mean) * torch.rsqrt(var + self.eps) + self.beta


class CepstralNorm(GlobalLayerNorm):
    """Per-channel LN over time, eps 10e-8."""

    dims = (2,)


class BatchNorm1dEval(nn.Module):
    """torch ``nn.BatchNorm1d`` in eval mode, in every mode: the running
    statistics normalize, and they are trainable params."""

    def __init__(self, channels: int, eps: float = 1e-5, *, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.running_mean = nn.Parameter(torch.zeros(channels, device=device))
        self.running_var = nn.Parameter(torch.ones(channels, device=device))

    def forward(self, x):
        inv = torch.rsqrt(self.running_var + self.eps)[None, :, None]
        return ((x - self.running_mean[None, :, None]) * inv * self.weight[None, :, None]
                + self.bias[None, :, None])


class TCNBlock(nn.Module):
    """1x1 -> PReLU -> norm -> dilated depthwise -> PReLU -> norm -> 1x1, plus
    the input."""

    def __init__(self, b: int, h: int, p: int, d: int, cepstral: bool = False, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        g = default_generator(generator)
        norm = CepstralNorm if cepstral else GlobalLayerNorm
        self.m = nn.Sequential(
            Conv1d(b, h, 1, generator=g, device=device), PReLU(device=device),
            norm(h, device=device),
            Conv1d(h, h, p, padding=(d * (p - 1)) // 2, dilation=d, groups=h, generator=g,
                   device=device),
            PReLU(device=device), norm(h, device=device),
            Conv1d(h, b, 1, generator=g, device=device))

    def forward(self, x):
        return x + self.m(x)


class _TwoStepTN(nn.Module):
    """The front end, mask head and back end TDCN and ResidualTN share."""

    def __init__(self, N: int, L: int, B: int, S: int, norm, generator, device):
        super().__init__()
        g = generator
        self.N, self.B, self.S = N, B, S
        self.fe = nn.Sequential(Conv1d(1, N, L, stride=L // 2, padding=L // 2, generator=g,
                                       device=device), nn.ReLU())
        self.ln = norm(N, device=device)
        self.l1 = Conv1d(N, B, 1, generator=g, device=device)

    def _head(self, g, L, device, norm):
        N, B, S = self.N, self.B, self.S
        if B != N:
            self.reshape_before_masks = Conv1d(B, N, 1, generator=g, device=device)
        self.ln_mask_in = norm(N, device=device)
        self.m = MaskConv2d(S, N, generator=g, device=device)
        self.be = ConvTranspose1d(N * S, S, L, stride=L // 2, padding=L // 2,
                                  output_padding=(L // 2) - 1, groups=S, use_bias=True,
                                  weight_init=kaiming_uniform_conv, generator=g,
                                  device=device)

    def _masks_and_decode(self, x, s):
        if self.B != self.N:
            x = self.reshape_before_masks(x)
        x = torch.relu(self.m(self.ln_mask_in(x)[:, None, :, :]))
        x = torch.sigmoid(x) if self.S == 1 else torch.softmax(x, dim=1)
        x = x * s[:, None, :, :]
        return self.be(x.reshape(x.shape[0], -1, x.shape[-1]))


class TDCN(_TwoStepTN):
    """Input (B, [1,] T) -> (B, S, T') with T' from the transposed conv.
    Defaults: the published configuration (N 256, L 21, B 256, H 512, X 8,
    R 4; 8.63 M params)."""

    def __init__(self, N: int = 256, L: int = 21, B: int = 256, H: int = 512, P: int = 3,
                 X: int = 8, R: int = 4, S: int = 2, *,
                 generator: Optional[torch.Generator] = None, device=None):
        g = default_generator(generator)
        super().__init__(N, L, B, S, GlobalLayerNorm, g, device)
        self.sm = nn.Sequential(*(TCNBlock(B, H, P, 2**d, generator=g, device=device)
                                  for _ in range(R) for d in range(X)))
        self._head(g, L, device, GlobalLayerNorm)

    def forward(self, x):
        if x.ndim == 2:
            x = x[:, None, :]
        s = self.fe(x)
        return self._masks_and_decode(self.sm(self.l1(self.ln(s))), s)


class ResidualTN(_TwoStepTN):
    """TDCN with long-range normalized residual mixes. Defaults: the
    published configuration (9.42 M params)."""

    def __init__(self, N: int = 256, L: int = 21, B: int = 256, H: int = 512, P: int = 3,
                 X: int = 8, R: int = 4, S: int = 2, *,
                 generator: Optional[torch.Generator] = None, device=None):
        if R * X < 28:
            raise ValueError(f"ResidualTN's residual table needs R * X >= 28, got {R * X}")
        g = default_generator(generator)
        super().__init__(N, L, B, S, BatchNorm1dEval, g, device)
        self.table = [_RESIDUALS.get(i, ()) for i in range(R * X)]
        # one norm per distinct residual source, numbered in the order the
        # table first names it; one dense per layer that takes residuals
        self.norm_of = {}
        for conns in self.table:
            for src in conns:
                self.norm_of.setdefault(src, len(self.norm_of))
        self.dense_of = {l: j for j, l in enumerate(
            l for l, conns in enumerate(self.table) if conns)}
        self.sm = nn.ModuleList(TCNBlock(B, H, P, 2 ** (l % X), cepstral=True, generator=g,
                                         device=device) for l in range(R * X))
        self.residual_norms = nn.ModuleList(CepstralNorm(B, device=device)
                                            for _ in self.norm_of)
        self.residual_denses = nn.ModuleList(
            Conv1d(len(self.table[l]) * B, B, 1, generator=g, device=device)
            for l in self.dense_of)
        self._head(g, L, device, BatchNorm1dEval)

    def forward(self, x):
        if x.ndim == 2:
            x = x[:, None, :]
        s = self.fe(x)
        x = self.l1(self.ln(s))
        outputs = {-1: x}
        for l, block in enumerate(self.sm):
            conns = self.table[l]
            if conns:
                res = torch.cat([self.residual_norms[self.norm_of[src]](outputs[src])
                                 for src in conns], dim=1)
                x = x + self.residual_denses[self.dense_of[l]](res)
            x = block(x)
            if l in self.norm_of:
                outputs[l] = x
        return self._masks_and_decode(x, s)
