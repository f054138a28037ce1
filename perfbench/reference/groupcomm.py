"""GroupComm SuDoRM-RF v2 forward in plain PyTorch, from a name -> tensor
dict with the torch reference's parameter names (``sm.{i}.TAC.TAC_input.0.
weight``, ``sm.{i}.UBlock.proj_1x1.conv.weight``, ...).

  encoder Conv1d(C_audio -> N, k=L, stride=L//2, pad=L//2, no bias) ->
  GlobLN -> 1x1 bottleneck N -> C -> num_blocks x (TAC, then the shared
  U-ConvBlock on the group-folded (B*G, C/G, T') layout) -> PReLU -> 1x1
  conv C -> S*C_audio*N -> ReLU masks times the pre-norm encoder features
  -> ConvTranspose1d(S*C_audio*N -> S*C_audio), on the input padded to a
  multiple of (L//2) * 2**depth and cropped back: ``improved.forward``'s
  front and back end with C_audio input channels.

  TAC over the G groups of n = C/G channels, hidden h = 3n: a Linear n -> h
  and a PReLU on each group; the mean over the groups, a Linear h -> h and a
  PReLU; the mean broadcast to every group and concatenated after the
  group's own hidden (2h channels), a Linear 2h -> n and a PReLU; GlobLN of
  each (batch, group); plus the block's input.

Departures from the upstream module (``groupcomm_sudormrf_v2.py``, TAC
from yluo42/GC3), none of them in the arithmetic: each Linear is a matmul
over the channel axis of (..., C, T) where upstream permutes the time axis
ahead and applies ``nn.Linear`` to the last axis; the shared block and the
front and back end are ``improved``'s functions; the weights come as a
dict, not a module; forward only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.improved import glob_ln, prelu, u_conv_block


def linear(w, p: str, x):
    """Linear ``p`` over the channel axis of x (..., C, T)."""
    return torch.matmul(w[p + "weight"], x) + w[p + "bias"][:, None]


def tac(w, p: str, x, g: int):
    """TAC of block prefix ``p`` over x (B, C, T') in ``g`` groups."""
    b, c, t = x.shape
    n = c // g
    y = prelu(linear(w, p + "TAC_input.0.", x.reshape(b, g, n, t)),
              w[p + "TAC_input.1.weight"])  # (B, G, h, T')
    mean = prelu(linear(w, p + "TAC_mean.0.", y.mean(dim=1)),
                 w[p + "TAC_mean.1.weight"])  # (B, h, T')
    cat = torch.cat([y, mean[:, None].expand(-1, g, -1, -1)], dim=2)  # (B, G, 2h, T')
    out = prelu(linear(w, p + "TAC_output.0.", cat), w[p + "TAC_output.1.weight"])
    out = glob_ln(out.reshape(b * g, n, t), w[p + "TAC_norm.gamma"], w[p + "TAC_norm.beta"])
    return x + out.reshape(b, c, t)


def forward(w: dict, hp: dict, wav):
    """wav (B, T) or (B, C_audio, T) -> estimates (B, S*C_audio, T)."""
    if wav.ndim == 2:
        wav = wav[:, None, :]
    b, _, t = wav.shape
    k, depth, g = hp["enc_kernel_size"], hp["upsampling_depth"], hp["group_size"]
    n, s = hp["enc_num_basis"], hp["num_sources"] * hp["in_audio_channels"]
    half = k // 2
    multiple = half * 2 ** depth
    padded = max(-(-t // multiple), 1) * multiple
    x = F.pad(wav, (0, padded - t))
    enc = F.conv1d(x, w["encoder.weight"], stride=half, padding=half)
    x = glob_ln(enc, w["ln.gamma"], w["ln.beta"])
    x = F.conv1d(x, w["bottleneck.weight"], w["bottleneck.bias"])
    c, frames = x.shape[1], x.shape[2]
    for i in range(hp["num_blocks"]):
        x = tac(w, f"sm.{i}.TAC.", x, g)
        x = u_conv_block(w, f"sm.{i}.UBlock.", x.reshape(b * g, c // g, frames), depth)
        x = x.reshape(b, c, frames)
    x = prelu(x, w["mask_net.0.weight"])
    x = F.conv1d(x, w["mask_net.1.weight"], w["mask_net.1.bias"])
    x = torch.relu(x.view(b, s, n, -1)) * enc[:, None]
    est = F.conv_transpose1d(x.view(b, s * n, -1), w["decoder.weight"], stride=half,
                             padding=half, output_padding=half - 1)
    return est[..., :t]
