"""Improved SuDoRM-RF forward in plain PyTorch, from a name -> tensor dict
with the torch reference's parameter names.

  encoder Conv1d(1 -> N, k=L, stride=L//2, pad=L//2, no bias) -> GlobLN ->
  1x1 bottleneck N -> C -> num_blocks x U-ConvBlock -> PReLU -> 1x1 conv
  C -> S*N -> ReLU masks times the pre-norm encoder features ->
  ConvTranspose1d(S*N -> S, k=L, stride=L//2, pad=L//2, output_padding
  L//2 - 1, no bias), on the input padded to a multiple of
  (L//2) * 2**depth and cropped back.

  U-ConvBlock: 1x1 C -> Ci, GlobLN, PReLU; ``depth`` depthwise k=5 convs
  (stride 1, then 2), each with GlobLN; from the deepest level up, each
  level plus the nearest x2 upsampling of the sum below it; GlobLN, PReLU,
  1x1 Ci -> C, plus the block's input.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def glob_ln(x, gamma, beta, eps: float = 1e-8):
    mean = x.mean(dim=(1, 2), keepdim=True)
    var = (x - mean).square().mean(dim=(1, 2), keepdim=True)
    return gamma[None, :, None] * (x - mean) / torch.sqrt(var + eps) + beta[None, :, None]


def prelu(x, slope):
    return torch.where(x >= 0, x, slope * x)


def u_conv_block(w, p: str, x, depth: int):
    ci = w[p + "proj_1x1.conv.weight"].shape[0]
    y = F.conv1d(x, w[p + "proj_1x1.conv.weight"], w[p + "proj_1x1.conv.bias"])
    y = glob_ln(y, w[p + "proj_1x1.norm.gamma"], w[p + "proj_1x1.norm.beta"])
    y = prelu(y, w[p + "proj_1x1.act.weight"])
    levels, cur = [], y
    for k in range(depth):
        q = f"{p}spp_dw.{k}."
        cur = F.conv1d(cur, w[q + "conv.weight"], w[q + "conv.bias"],
                       stride=1 if k == 0 else 2, padding=2, groups=ci)
        cur = glob_ln(cur, w[q + "norm.gamma"], w[q + "norm.beta"])
        levels.append(cur)
    acc = levels[-1]
    for k in range(depth - 2, -1, -1):
        acc = levels[k] + acc.repeat_interleave(2, dim=-1)
    acc = glob_ln(acc, w[p + "final_norm.norm.gamma"], w[p + "final_norm.norm.beta"])
    acc = prelu(acc, w[p + "final_norm.act.weight"])
    return F.conv1d(acc, w[p + "res_conv.weight"], w[p + "res_conv.bias"]) + x


def forward(w: dict, hp: dict, wav):
    """wav (B, T) -> estimates (B, S, T)."""
    b, t = wav.shape
    k, depth = hp["enc_kernel_size"], hp["upsampling_depth"]
    n, s = hp["enc_num_basis"], hp["num_sources"]
    half = k // 2
    multiple = half * 2 ** depth
    padded = max(-(-t // multiple), 1) * multiple
    x = F.pad(wav[:, None, :], (0, padded - t))
    enc = F.conv1d(x, w["encoder.weight"], stride=half, padding=half)
    x = glob_ln(enc, w["ln.gamma"], w["ln.beta"])
    x = F.conv1d(x, w["bottleneck.weight"], w["bottleneck.bias"])
    for i in range(hp["num_blocks"]):
        x = u_conv_block(w, f"sm.{i}.", x, depth)
    x = prelu(x, w["mask_net.0.weight"])
    x = F.conv1d(x, w["mask_net.1.weight"], w["mask_net.1.bias"])
    x = torch.relu(x.view(b, s, n, -1)) * enc[:, None]
    est = F.conv_transpose1d(x.view(b, s * n, -1), w["decoder.weight"], stride=half,
                             padding=half, output_padding=half - 1)
    return est[..., :t]

