"""The U-ConvBlock forward (counterpart of ``sudo_rm_rf_tpu/ops/pallas/uconv.py``).

Four forms of one function, all with the JAX package's parameter dict (``kp``,
see :func:`uconv_block_reference`) and (B, C, T) layout:

* :func:`uconv_block_reference` — plain ops, the oracle;
* :func:`uconv_block_fma` — shifted multiply-adds with each GlobLN folded into
  per-channel (a, b) constants, autograd-able;
* :func:`uconv_block_levelwise` — the exact decomposition the CUDA kernel
  carries out (3xTF32 GEMMs, per-tile statistics merged with Chan's formula,
  level-wise folding, the closed-form upsample-sum with per-chunk
  statistics), in plain torch, so the CPU tests check the kernel's algorithm;
* :func:`fused_uconv_block` — the wrapper of the hand-written Hopper kernel
  ``csrc/uconv.cu`` (forward only).
"""

from __future__ import annotations

import ctypes

import torch

from sudo_rm_rf_tpu_torch.ops.conv import conv1d
from sudo_rm_rf_tpu_torch.ops.norm import glob_ln
from sudo_rm_rf_tpu_torch.ops.resample import upsample_nearest_2x

EPS = 1e-8
# (channels, time steps) of the sub-tile whose GlobLN moments the kernel's
# proj GEMM writes (SUB x SUB in csrc/uconv.cu). The GEMM computes out^T:
# each warpgroup holds 64 time rows x 64 channels per accumulator, one
# sub-tile, whatever the block's width.
GEMM_TILE = (64, 64)
# outputs of the upsample-sum whose exact (mean, M2) one thread takes before
# merging (CHUNK in csrc/uconv.cu)
UPSUM_CHUNK = 8


def _prelu(v, slope):
    return torch.where(v >= 0, v, slope * v)


def uconv_block_reference(x, params, depth: int):
    """Plain block with the kernel's parameterization.

    params dict:
      proj_w (Ci, Co), proj_b (Ci,), proj_g/proj_beta (Ci,), proj_slope (),
      dw_w (depth, Ci, 5), dw_b (depth, Ci), dw_g/dw_beta (depth, Ci),
      final_g/final_beta (Ci,), final_slope (),
      res_w (Co, Ci), res_b (Co,)
    """
    ci = params["proj_w"].shape[0]
    y = torch.matmul(params["proj_w"], x) + params["proj_b"][None, :, None]
    y = glob_ln(y, params["proj_g"], params["proj_beta"])
    y = _prelu(y, params["proj_slope"])

    pyramid = []
    cur = y
    for k in range(depth):
        cur = conv1d(cur, params["dw_w"][k][:, None, :], params["dw_b"][k],
                     stride=1 if k == 0 else 2, padding=2, groups=ci)
        cur = glob_ln(cur, params["dw_g"][k], params["dw_beta"][k])
        pyramid.append(cur)

    acc = pyramid[-1]
    for k in range(depth - 2, -1, -1):
        acc = pyramid[k] + upsample_nearest_2x(acc)

    acc = glob_ln(acc, params["final_g"], params["final_beta"])
    acc = _prelu(acc, params["final_slope"])
    out = torch.matmul(params["res_w"], acc) + params["res_b"][None, :, None]
    return out + x


def uconv_block_fma(x, params, depth: int):
    """Plain block with the kernel's algebraic optimizations: depthwise convs
    as 5 shifted multiply-adds (stride 2 phase-split into even and odd
    planes), and each ladder GlobLN folded into the next conv's input as
    per-channel (a, b), with one-pass sum / sum-of-squares statistics."""
    b, _, _ = x.shape
    ci = params["proj_w"].shape[0]
    y = torch.matmul(params["proj_w"], x) + params["proj_b"][None, :, None]
    y = glob_ln(y, params["proj_g"], params["proj_beta"])
    y = _prelu(y, params["proj_slope"])

    def stats(o, n):
        o32 = o.float()
        s1 = o32.sum(dim=(1, 2), keepdim=True)
        s2 = (o32 * o32).sum(dim=(1, 2), keepdim=True)
        mean = s1 / n
        var = torch.clamp(s2 / n - mean * mean, min=0.0)
        return mean, torch.rsqrt(var + EPS)

    def conv_s1(v, w):  # v (B, C, T); w (C, 5)
        tt = v.shape[-1]
        vp = torch.nn.functional.pad(v, (2, 2))
        return sum(w[None, :, j : j + 1] * vp[..., j : j + tt] for j in range(5))

    def conv_s2(v, w):
        th = v.shape[-1] // 2
        vr = v.reshape(b, ci, th, 2)
        ve_p = torch.nn.functional.pad(vr[..., 0], (1, 1))
        vo_p = torch.nn.functional.pad(vr[..., 1], (1, 0))
        wc = w[None, :, :, None]
        return (
            wc[:, :, 0] * ve_p[..., 0:th]
            + wc[:, :, 1] * vo_p[..., 0:th]
            + wc[:, :, 2] * ve_p[..., 1 : th + 1]
            + wc[:, :, 3] * vo_p[..., 1:]
            + wc[:, :, 4] * ve_p[..., 2 : th + 2]
        )

    a = torch.ones((1, ci, 1), dtype=y.dtype, device=y.device)
    bb = torch.zeros((1, ci, 1), dtype=y.dtype, device=y.device)
    cur, raw, folds = y, [], []
    for k in range(depth):
        x_in = a * cur + bb
        o = conv_s1(x_in, params["dw_w"][k]) if k == 0 else conv_s2(x_in, params["dw_w"][k])
        o = o + params["dw_b"][k][None, :, None]
        mean, inv = stats(o, ci * o.shape[-1])
        g = params["dw_g"][k].float()[None, :, None]
        be = params["dw_beta"][k].float()[None, :, None]
        a = (g * inv).to(o.dtype)
        bb = (be - g * inv * mean).to(o.dtype)
        raw.append(o)
        folds.append((a, bb))
        cur = o

    a, bb = folds[-1]
    acc = a * raw[-1] + bb
    for k in range(depth - 2, -1, -1):
        a, bb = folds[k]
        acc = (a * raw[k] + bb) + upsample_nearest_2x(acc)

    acc = glob_ln(acc, params["final_g"], params["final_beta"])
    acc = _prelu(acc, params["final_slope"])
    out = torch.matmul(params["res_w"], acc) + params["res_b"][None, :, None]
    return out + x


def tf32_round(v):
    """Round fp32 to the nearest TF32 value (10-bit mantissa), ties away from
    zero: ``cvt.rna.tf32.f32`` on the int32 view."""
    bits = v.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def matmul_3xtf32(w, x):
    """w @ x as the kernel's tensor cores take it: each operand split into
    hi = tf32(v) and lo = tf32(v - hi), and lo*hi + hi*lo + hi*hi summed in
    fp32 (the lo*lo term is dropped)."""
    w_hi, x_hi = tf32_round(w), tf32_round(x)
    w_lo, x_lo = tf32_round(w - w_hi), tf32_round(x - x_hi)
    return (torch.matmul(w_hi, x_lo) + torch.matmul(w_lo, x_hi)) + torch.matmul(w_hi, x_hi)


def _tile_moments(v, rows: int, cols: int):
    """Per-tile (count, mean, M2) of v (B, C, T) cut into (rows, cols) tiles,
    ragged edges included — the partials the kernel's blocks write."""
    b, c, t = v.shape
    pr, pc = -c % rows, -t % cols
    vp = torch.nn.functional.pad(v, (0, pc, 0, pr))
    mask = torch.nn.functional.pad(torch.ones_like(v), (0, pc, 0, pr))
    shape = (b, (c + pr) // rows, rows, (t + pc) // cols, cols)
    vp, mask = vp.reshape(shape), mask.reshape(shape)
    n = mask.sum(dim=(2, 4))
    mean = vp.sum(dim=(2, 4)) / n
    m2 = (((vp - mean[:, :, None, :, None]) * mask) ** 2).sum(dim=(2, 4))
    return n.reshape(b, -1), mean.reshape(b, -1), m2.reshape(b, -1)


def _fold(v, gamma, beta, rows: int, cols: int):
    """GlobLN of v as per-(batch, channel) (a, b), norm(v) = a*v + b, from
    per-tile partials merged with Chan's formula in float64."""
    n, mean, m2 = (p.double() for p in _tile_moments(v, rows, cols))
    total = n.sum(dim=1, keepdim=True)
    mu = (n * mean).sum(dim=1, keepdim=True) / total
    var = (m2.sum(dim=1, keepdim=True)
           + (n * (mean - mu) ** 2).sum(dim=1, keepdim=True)) / total
    rstd = torch.rsqrt(var + EPS).float()
    mu = mu.float()
    a = gamma[None, :] * rstd
    return (a[:, :, None], (beta[None, :] - a * mu)[:, :, None])


def uconv_block_levelwise(x, params, depth: int):
    """The CUDA kernel's decomposition of the block, in plain torch.

    proj GEMM in 3xTF32 (partials per ``GEMM_TILE`` sub-tile) -> per level
    k: input transform (level 0: prelu(a*y + b); k >= 1: a_{k-1}*raw_{k-1} +
    b_{k-1}), depthwise k=5 conv y[t] = sum_j w[j] x[s*t + j - 2], raw_k and
    per-row partials -> acc = sum_k (a_k raw_k[t >> k] + b_k) with partials
    per ``UPSUM_CHUNK`` outputs -> res GEMM in 3xTF32 over prelu(a_f*acc +
    b_f) plus bias and residual.
    """
    t = x.shape[-1]
    y = matmul_3xtf32(params["proj_w"], x) + params["proj_b"][None, :, None]
    a, b = _fold(y, params["proj_g"], params["proj_beta"], *GEMM_TILE)
    cur = _prelu(a * y + b, params["proj_slope"])
    raw, folds = [], []
    for k in range(depth):
        if k > 0:
            cur = a * raw[-1] + b
        s = 1 if k == 0 else 2
        tk = cur.shape[-1] // s
        xp = torch.nn.functional.pad(cur, (2, 2))
        w = params["dw_w"][k]
        o = sum(w[None, :, j : j + 1] * xp[..., j : j + s * tk : s] for j in range(5))
        o = o + params["dw_b"][k][None, :, None]
        a, b = _fold(o, params["dw_g"][k], params["dw_beta"][k], 1, tk)
        raw.append(o)
        folds.append((a, b))
    acc = sum(
        (fa * r + fb).repeat_interleave(2**k, dim=-1)[..., :t]
        for k, (r, (fa, fb)) in enumerate(zip(raw, folds))
    )
    a, b = _fold(acc, params["final_g"], params["final_beta"], 1, UPSUM_CHUNK)
    out = matmul_3xtf32(params["res_w"], _prelu(a * acc + b, params["final_slope"]))
    return out + params["res_b"][None, :, None] + x


def fused_uconv_block(x, params, depth: int = 5, pyramid_dtype=torch.float32):
    """Run the U-ConvBlock. x: (B, Co, T) fp32; returns (B, Co, T).

    On a CUDA tensor this launches the Hopper kernel (``csrc/uconv.cu``) or
    raises; on a CPU tensor it runs the plain :func:`uconv_block_reference`.
    T must be divisible by 2**(depth-1). Forward only: on a CUDA tensor it
    raises where autograd would need a gradient.
    """
    if x.device.type == "cpu":
        return uconv_block_reference(x, params, depth)
    if x.device.type != "cuda":
        raise ValueError(f"fused_uconv_block: unsupported device {x.device}")
    if pyramid_dtype != torch.float32:
        raise NotImplementedError("fused_uconv_block: only a float32 pyramid")
    if x.dtype != torch.float32 or x.ndim != 3 or not x.is_contiguous():
        raise ValueError(
            f"fused_uconv_block: x must be a contiguous 3-D float32 tensor, "
            f"got {x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}")
    b, co, t = x.shape
    ci = params["proj_w"].shape[0]
    if depth < 1 or t % (2 ** (depth - 1)):
        raise ValueError(f"fused_uconv_block: T={t} not divisible by 2**(depth-1), depth={depth}")
    # every param's shape, in the order of the C entry point's arguments
    want = {
        "proj_w": (ci, co), "proj_b": (ci,), "proj_g": (ci,), "proj_beta": (ci,),
        "proj_slope": (), "dw_w": (depth, ci, 5), "dw_b": (depth, ci),
        "dw_g": (depth, ci), "dw_beta": (depth, ci), "final_g": (ci,),
        "final_beta": (ci,), "final_slope": (), "res_w": (co, ci), "res_b": (co,),
    }
    for key in want:
        p = params[key]
        if (p.device != x.device or p.dtype != torch.float32
                or not p.is_contiguous() or tuple(p.shape) != want[key]):
            raise ValueError(
                f"fused_uconv_block: params[{key!r}] must be a contiguous float32 "
                f"{want[key]} tensor on {x.device}, got {p.dtype} {tuple(p.shape)} "
                f"on {p.device}")
    if torch.is_grad_enabled() and (
            x.requires_grad or any(params[key].requires_grad for key in want)):
        raise RuntimeError("fused_uconv_block has no backward: call it under "
                           "torch.no_grad() or torch.inference_mode()")

    from sudo_rm_rf_tpu_torch.ops._build import load_kernels

    lib = load_kernels()
    with torch.cuda.device(x.device):
        out = torch.empty_like(x)
        ws = lib.uconv_workspace_floats(b, co, ci, t, depth)
        work = torch.empty(ws, dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        ptr = lambda v: ctypes.c_void_p(v.data_ptr())
        err = lib.uconv_block_forward(
            ptr(x), ptr(out), *(ptr(params[key]) for key in want),
            ptr(work), b, co, ci, t, depth, ctypes.c_float(EPS),
            ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"fused_uconv_block: CUDA launch failed: "
                           f"{lib.cuda_error_string(err).decode()} ({err})")
    fused_uconv_block.launches += 1
    return out


fused_uconv_block.launches = 0


def params_from_module(block) -> dict:
    """Map a :class:`models.improved_sudormrf.UConvBlock` to the kernel's
    parameter dict (counterpart of ``params_from_flax``)."""
    dw = block.spp_dw
    return {
        "proj_w": block.proj_1x1.conv.weight[:, :, 0],
        "proj_b": block.proj_1x1.conv.bias,
        "proj_g": block.proj_1x1.norm.gamma,
        "proj_beta": block.proj_1x1.norm.beta,
        "proj_slope": block.proj_1x1.act.weight[0],
        "dw_w": torch.stack([m.conv.weight[:, 0, :] for m in dw]),
        "dw_b": torch.stack([m.conv.bias for m in dw]),
        "dw_g": torch.stack([m.norm.gamma for m in dw]),
        "dw_beta": torch.stack([m.norm.beta for m in dw]),
        "final_g": block.final_norm.norm.gamma,
        "final_beta": block.final_norm.norm.beta,
        "final_slope": block.final_norm.act.weight[0],
        "res_w": block.res_conv.weight[:, :, 0],
        "res_b": block.res_conv.bias,
    }
