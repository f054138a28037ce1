"""Causal SuDoRM-RF v3 forward in plain PyTorch, and the streaming rule, from
a name -> tensor dict with the program's parameter names (``encoder.weight``,
``sm.{i}.proj_1x1.conv.weight``, ``sm.{i}.spp_dw.{k}.act.weight``,
``sm.{i}.skipinit_gain``, ``mask_nl_class.weight``, ...).

  input padded with zeros to a multiple of (L//2) * 2**depth -> encoder
  Conv1d(C_audio -> N, k=2L-1, stride=L//2, pad=L-1, no bias) -> 1x1
  bottleneck N -> C -> num_blocks x U-ConvBlock -> PReLU -> 1x1 conv
  C -> S*C_audio*N -> PReLU, the mask itself the representation (no product
  with the encoder features) -> ConvTranspose1d(S*C_audio*N -> S*C_audio,
  k=L, stride=L//2, pad=L//2, output_padding=L//2-1, no bias), cropped back.

  U-ConvBlock, no norm anywhere: PReLU(1x1 C -> Ci), then ``depth`` levels of
  PReLU(depthwise k=21, pad 10), stride 1 at level 0 and 2 after; from the
  coarsest level up, each level plus the nearest x2 upsample of the sum
  below; a 1x1 Ci -> C, times the block's scalar ``skipinit_gain``, plus
  the block's input.

  Causality: every conv of kernel k >= 3 (the encoder and the depthwise
  convs) has its last k//2 taps zeroed, here in the weight each forward
  reads. The decoder is not masked: it reads L//2 samples ahead.

Departures from the upstream module (``causal_improved_sudormrf_v3.py``),
none of them in the arithmetic: its alpha and beta scales are 1 in every
configuration and left out; the weights come as a dict; forward only.

Streaming: a stream's window at step t (0-based: the window after its
t-th hop was pushed) is the ``window`` samples that end at (t + 1) * hop in
its audio, read round the end of the audio (a looped stream), with zeros
before its first sample; a step emits the window's hop that ends
``lookahead`` samples behind the newest input.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def masked(weight):
    """The weight with its last k//2 taps zeroed, for k >= 3."""
    k = weight.shape[-1]
    if k < 3:
        return weight
    mask = torch.ones(k, dtype=weight.dtype, device=weight.device)
    mask[k - k // 2:] = 0.0
    return weight * mask


def conv(w, p: str, x, stride: int = 1, groups: int = 1):
    """Causally masked conv ``p`` (its bias if it has one), padded by
    (k - 1) // 2 on both sides."""
    weight = w[p + "weight"]
    return F.conv1d(x, masked(weight), w.get(p + "bias"), stride=stride,
                    padding=(weight.shape[-1] - 1) // 2, groups=groups)


def block(w, p: str, x, depth: int):
    """One causal U-ConvBlock of prefix ``p`` over x (B, C, T')."""
    cur = F.prelu(conv(w, p + "proj_1x1.conv.", x), w[p + "proj_1x1.act.weight"])
    ci = cur.shape[1]
    levels = []
    for k in range(depth):
        cur = F.prelu(conv(w, f"{p}spp_dw.{k}.conv.", cur, stride=1 if k == 0 else 2,
                           groups=ci), w[f"{p}spp_dw.{k}.act.weight"])
        levels.append(cur)
    acc = levels[-1]
    for k in range(depth - 2, -1, -1):
        acc = levels[k] + torch.repeat_interleave(acc, 2, dim=-1)
    return conv(w, p + "res_conv.", acc) * w[p + "skipinit_gain"] + x


def forward(w: dict, hp: dict, wav):
    """wav (B, T) or (B, C_audio, T) -> estimates (B, S*C_audio, T)."""
    if wav.ndim == 2:
        wav = wav[:, None, :]
    t = wav.shape[-1]
    k, depth = hp["enc_kernel_size"], hp["upsampling_depth"]
    n, s = hp["enc_num_basis"], hp["num_sources"] * hp["in_audio_channels"]
    half = k // 2
    multiple = half * 2 ** depth
    x = F.pad(wav, (0, max(-(-t // multiple), 1) * multiple - t))
    x = conv(w, "encoder.", x, stride=half)
    x = conv(w, "bottleneck.", x)
    for i in range(hp["num_blocks"]):
        x = block(w, f"sm.{i}.", x, depth)
    x = F.prelu(x, w["mask_net.0.weight"])
    x = conv(w, "mask_net.1.", x)
    b = x.shape[0]
    x = F.prelu(x.reshape(b, s, n, -1), w["mask_nl_class.weight"])
    est = F.conv_transpose1d(x.reshape(b, s * n, -1), w["decoder.weight"], stride=half,
                             padding=half, output_padding=half - 1)
    return est[..., :t]


def windows(audio: np.ndarray, step: int, hop: int, window: int) -> np.ndarray:
    """(N, window) windows of the N streams of ``audio`` (N, L) at ``step``:
    the samples ending at (step + 1) * hop, round the end of the audio,
    zeros before the first."""
    end = (step + 1) * hop
    idx = np.arange(end - window, end)
    out = audio[:, idx % audio.shape[1]].astype(np.float32)
    out[:, idx < 0] = 0.0
    return out


def emitted(est, hop: int, lookahead: int):
    """The hop a step emits from the estimates (..., window) of its window."""
    w = est.shape[-1]
    return est[..., w - lookahead - hop: w - lookahead]
