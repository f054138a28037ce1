"""The U-ConvBlock forward (counterpart of ``sudo_rm_rf_tpu/ops/pallas/uconv.py``).

Four forms of one function, all with the JAX package's parameter dict (``kp``,
see :func:`uconv_block_reference`) and (B, C, T) layout:

* :func:`uconv_block_reference` — plain ops, the oracle; in the dtype of its
  inputs (fp32, or bf16 with fp32 GlobLN statistics);
* :func:`uconv_block_fma` — shifted multiply-adds with each GlobLN folded into
  per-channel (a, b) constants, autograd-able; fp32 or bf16 (fp32
  statistics), with an optional ``matmul`` hook for the two 1x1 products
  (the int8 serving path's);
* :func:`uconv_block_levelwise` — the exact decomposition the CUDA kernel
  carries out (3xTF32 GEMMs, per-tile statistics merged with Chan's formula,
  level-wise folding from the ladder's partials per (rows, time tile) of
  :func:`ladder_work`, the closed-form upsample-sum with per-chunk
  statistics), in plain torch, so the CPU tests check the kernel's
  algorithm; fp32 in and out, with an fp32 or bf16 pyramid;
* :func:`fused_uconv_block` — the wrapper of the hand-written Hopper kernel
  ``csrc/uconv.cu``: forward only, fp32 in and out, with an fp32 or bf16
  pyramid (the TPU kernel's ``pyramid_dtype``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sudo_rm_rf_tpu_torch.ops import _build
from sudo_rm_rf_tpu_torch.ops.conv import conv1d
from sudo_rm_rf_tpu_torch.ops.norm import glob_ln
from sudo_rm_rf_tpu_torch.ops.resample import upsample_nearest_2x
from sudo_rm_rf_tpu_torch.parallel.collectives import (
    all_reduce_sum,
    copy_to_group,
    group_rank,
    group_size,
    reduce_from_group,
)

EPS = 1e-8
# (channels, time steps) of the sub-tile whose GlobLN moments the kernel's
# proj GEMM writes (SUB x SUB in csrc/uconv.cu). The GEMM computes out^T
# and writes each sub-tile's moments apart, whatever its route: a warpgroup
# of the narrow GEMM holds one sub-tile, a block of the wide GEMM four.
GEMM_TILE = (64, 64)
# the least output and input channels of a 1x1 product that takes the wide
# GEMM (csrc/uconv.cu: wide::route; one block is 128 channels x 128 time steps)
GEMM_WIDE_MIN = 128
# outputs of the upsample-sum whose exact (mean, M2) one thread takes before
# merging (CHUNK in csrc/uconv.cu)
UPSUM_CHUNK = 8
# the ladder's work a warp (csrc/uconv.cu: LANE_OUT, PASS, MAX_TILE,
# MIN_WORK, FILL): the outputs a lane takes in one pass, a warp's pass, the
# longest time tile, the outputs a warp should take, and the warps a level
# should fill the card with
LADDER_LANE = 8
LADDER_PASS = 32 * LADDER_LANE
LADDER_MAX_TILE = 64 * LADDER_PASS
LADDER_MIN_WORK = 4 * LADDER_PASS
LADDER_FILL = 4096


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


def dw_conv_s1(v, w):
    """Depthwise k=5 conv, stride 1, pad 2, as 5 shifted multiply-adds.
    v (B, C, T); w (C, 5)."""
    tt = v.shape[-1]
    vp = torch.nn.functional.pad(v, (2, 2))
    return sum(w[None, :, j : j + 1] * vp[..., j : j + tt] for j in range(5))


def dw_conv_s2(v, w):
    """Depthwise k=5 conv, stride 2, pad 2, phase-split into the even and
    odd planes of v (B, C, T), T even; w (C, 5)."""
    b, c, t = v.shape
    th = t // 2
    vr = v.reshape(b, c, th, 2)
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


def uconv_block_fma(x, params, depth: int, matmul=None, tp_group=None):
    """Plain block with the kernel's algebraic optimizations: depthwise convs
    as 5 shifted multiply-adds (stride 2 phase-split into even and odd
    planes), and each ladder GlobLN folded into the next conv's input as
    per-channel (a, b), with one-pass sum / sum-of-squares statistics.

    matmul: optional ``fn(w (O, C), v (B, C, T)) -> (B, O, T)`` for the proj
    and res products (the int8 serving path's hook, ``models/quantized.py``).
    With it, ``params['proj_w']`` and ``params['res_w']`` may be whatever
    the hook takes (an int8 ``{'q', 's'}`` dict): they are passed through.

    tp_group: compute tensor parallelism (JAX's ``constrain``) over a model
    group whose ranks hold the same x and the whole params: each rank runs
    its contiguous 1/n of the Ci channels. The proj 1x1 is column-parallel,
    GlobLN's sums and sums of squares are all-reduced over the group in
    fp32, the ladder and the upsample-add stay local to each channel, and
    the res 1x1 is row-parallel with its partial outputs all-reduced. The
    math and the gradients are the unsharded block's (the params and x
    enter through ``copy_to_group``, so each rank's gradient of them is
    whole). Not with a ``matmul`` hook.
    """
    if matmul is None:
        matmul = torch.matmul
    proj_w = params["proj_w"]
    # proj_w's rows are the expanded Ci channels in both forms
    ci = proj_w["q"].shape[0] if isinstance(proj_w, dict) else proj_w.shape[0]
    x_in, norm = x, glob_ln
    if tp_group is not None:
        if matmul is not torch.matmul:
            raise ValueError("uconv_block_fma: tp_group takes no matmul hook")
        params = _tp_part(params, tp_group)
        x_in = copy_to_group(x, tp_group)
        norm = functools.partial(_tp_glob_ln, group=tp_group, n_channels=ci)
    y = matmul(params["proj_w"], x_in) + params["proj_b"][None, :, None]
    y = norm(y, params["proj_g"], params["proj_beta"])
    y = _prelu(y, params["proj_slope"])

    def stats(o, n):
        o32 = o.float()
        s = all_reduce_sum(torch.stack([o32.sum(dim=(1, 2)), (o32 * o32).sum(dim=(1, 2))]),
                           tp_group)[:, :, None, None]
        mean = s[0] / n
        var = torch.clamp(s[1] / n - mean * mean, min=0.0)
        return mean, torch.rsqrt(var + EPS)

    a = torch.ones((1, y.shape[1], 1), dtype=y.dtype, device=y.device)
    bb = torch.zeros((1, y.shape[1], 1), dtype=y.dtype, device=y.device)
    cur, raw, folds = y, [], []
    for k in range(depth):
        x_k = a * cur + bb
        o = (dw_conv_s1 if k == 0 else dw_conv_s2)(x_k, params["dw_w"][k])
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

    acc = norm(acc, params["final_g"], params["final_beta"])
    acc = _prelu(acc, params["final_slope"])
    out = reduce_from_group(matmul(params["res_w"], acc), tp_group)
    out = out + params["res_b"][None, :, None]
    return out + x


# the params of a block split over Ci in compute TP, and the dim of each
# that holds Ci
_TP_SPLIT = {"proj_w": 0, "proj_b": 0, "proj_g": 0, "proj_beta": 0, "dw_w": 1, "dw_b": 1,
             "dw_g": 1, "dw_beta": 1, "final_g": 0, "final_beta": 0, "res_w": 1}


def _tp_part(params, group):
    """This rank's channel part of a block's params for compute TP: its
    contiguous 1/n of Ci in each split param, the slopes whole, each through
    ``copy_to_group`` (a gradient that is this rank's part, summed over the
    group in the backward); ``res_b`` is added after the all-reduce and is
    used whole by every rank."""
    n, r = group_size(group), group_rank(group)
    ci = params["proj_w"].shape[0]
    if ci % n:
        raise ValueError(f"compute TP: Ci={ci} does not divide the model group of {n}")
    part = slice(r * ci // n, (r + 1) * ci // n)
    out = {}
    for key, v in params.items():
        if key == "res_b":
            out[key] = v
            continue
        v = copy_to_group(v, group)
        dim = _TP_SPLIT.get(key)
        out[key] = v if dim is None else v[(slice(None),) * dim + (part,)]
    return out


def _tp_glob_ln(x, gamma, beta, *, group, n_channels: int, eps: float = EPS):
    """GlobLN of a channel part x (B, C/n, T) of a (B, C, T) tensor split
    over ``group``: the sum and the sum of squares, in fp32, all-reduced;
    the population variance from them. gamma and beta are the part's."""
    x32 = x.float()
    s = all_reduce_sum(torch.stack([x32.sum(dim=(1, 2)), (x32 * x32).sum(dim=(1, 2))]),
                       group)[:, :, None, None]
    n = n_channels * x.shape[-1]
    mean = s[0] / n
    inv = torch.rsqrt(torch.clamp(s[1] / n - mean * mean, min=0.0) + eps)
    g32, b32 = gamma.float()[None, :, None], beta.float()[None, :, None]
    if x.dtype == torch.float32:
        return g32 * ((x - mean) * inv) + b32
    return (g32 * inv).to(x.dtype) * x + (b32 - g32 * inv * mean).to(x.dtype)


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


def gemm_wide(m: int, k: int) -> bool:
    """Whether the kernel's 1x1 product of ``m`` output and ``k`` input
    channels takes the wide GEMM (128-channel tiles, a producer warpgroup
    and two consumers) or the narrow one (64-channel tiles): the kernel's
    ``wide::route``, which the library exports as ``gemm_wide``. The route
    is a function of the shape alone: the proj product is (Ci, Co), the res
    product (Co, Ci)."""
    return m >= GEMM_WIDE_MIN and k >= GEMM_WIDE_MIN


def ladder_work(rows: int, tout: int) -> tuple:
    """(rows, time tile) that one warp of the kernel's ladder takes at a
    level of ``rows`` (B * Ci) rows and ``tout`` outputs a row: the kernel's
    ``ladder_work``, which the library exports as ``ladder_tiles``. A row is
    cut into at least cdiv(tout, LADDER_MAX_TILE) tiles, and into up to
    cdiv(LADDER_FILL, rows) where the rows alone leave the card short of
    warps, none shorter than one pass; the tile is a multiple of
    ``LADDER_LANE``. Where whole rows are shorter than ``LADDER_MIN_WORK``
    and the level has warps to spare, a warp takes several rows."""
    cdiv = lambda a, b: -(-a // b)  # noqa: E731
    fill = min(cdiv(LADDER_FILL, rows), cdiv(tout, LADDER_PASS))
    tiles = max(cdiv(tout, LADDER_MAX_TILE), fill)
    tile = cdiv(cdiv(tout, tiles), LADDER_LANE) * LADDER_LANE
    group = 1 if tile < tout else max(1, min(cdiv(LADDER_MIN_WORK, tout), rows // LADDER_FILL))
    return group, tile


def uconv_block_levelwise(x, params, depth: int, pyramid_dtype=torch.float32):
    """The CUDA kernel's decomposition of the block, in plain torch.

    proj GEMM in 3xTF32 (partials per ``GEMM_TILE`` sub-tile) -> per level
    k: input transform (level 0: prelu(a*y + b); k >= 1: a_{k-1}*raw_{k-1} +
    b_{k-1}), depthwise k=5 conv y[t] = sum_j w[j] x[s*t + j - 2], raw_k and
    partials per (rows, time tile) of :func:`ladder_work` -> acc =
    sum_k (a_k raw_k[t >> k] + b_k) with partials per ``UPSUM_CHUNK``
    outputs -> res GEMM in 3xTF32 over prelu(a_f*acc + b_f) plus bias and
    residual.

    pyramid_dtype: the type the levels are stored in (the TPU kernel's
    argument of that name). With bf16, as there, each level's statistics
    and the next level's input are its fp32 values; only the upsample-sum
    reads the stored levels, rounded to bf16 (nearest even) and upcast.
    """
    t = x.shape[-1]
    rows = x.shape[0] * params["proj_w"].shape[0]
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
        a, b = _fold(o, params["dw_g"][k], params["dw_beta"][k], *ladder_work(rows, tk))
        raw.append(o)
        folds.append((a, b))
    acc = sum(
        (fa * r.to(pyramid_dtype).float() + fb).repeat_interleave(2**k, dim=-1)[..., :t]
        for k, (r, (fa, fb)) in enumerate(zip(raw, folds))
    )
    a, b = _fold(acc, params["final_g"], params["final_beta"], 1, UPSUM_CHUNK)
    out = matmul_3xtf32(params["res_w"], _prelu(a * acc + b, params["final_slope"]))
    return out + params["res_b"][None, :, None] + x


PYRAMID_DTYPES = (torch.float32, torch.bfloat16)


def _checked_params(x, params, depth: int) -> list:
    """x's block ``params`` in the order of ``uconv_block_forward``'s
    arguments, checked by :func:`_build.check_params`."""
    co, ci = x.shape[1], params["proj_w"].shape[0]
    return _build.check_params("fused_uconv_block", x, params, {
        "proj_w": (ci, co), "proj_b": (ci,), "proj_g": (ci,), "proj_beta": (ci,),
        "proj_slope": (), "dw_w": (depth, ci, 5), "dw_b": (depth, ci),
        "dw_g": (depth, ci), "dw_beta": (depth, ci), "final_g": (ci,),
        "final_beta": (ci,), "final_slope": (), "res_w": (co, ci), "res_b": (co,)})


def fused_uconv_block(x, params, depth: int = 5, pyramid_dtype=torch.float32):
    """Run the U-ConvBlock. x: (B, Co, T) fp32; params fp32; returns (B, Co,
    T) fp32.

    pyramid_dtype: ``torch.float32`` (the default, as the TPU kernel's) or
    ``torch.bfloat16``, the type the ladder's levels are stored in for the
    upsample-sum (see :func:`uconv_block_levelwise`); anything else raises.

    On a CUDA tensor this launches the Hopper kernel (``csrc/uconv.cu``) or
    raises; on a CPU tensor it runs the plain version of the same function:
    :func:`uconv_block_reference` for an fp32 pyramid,
    :func:`uconv_block_levelwise` for a bf16 one. T must be divisible by
    2**(depth-1). Forward only: on a CUDA tensor it raises where autograd
    would need a gradient.
    """
    if pyramid_dtype not in PYRAMID_DTYPES:
        raise ValueError(f"fused_uconv_block: pyramid_dtype {pyramid_dtype} not in "
                         f"{PYRAMID_DTYPES}")
    if x.device.type == "cpu":
        if pyramid_dtype == torch.float32:
            return uconv_block_reference(x, params, depth)
        return uconv_block_levelwise(x, params, depth, pyramid_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"fused_uconv_block: unsupported device {x.device}")
    if x.dtype != torch.float32 or x.ndim != 3 or not x.is_contiguous():
        raise ValueError(
            f"fused_uconv_block: x must be a contiguous 3-D float32 tensor, "
            f"got {x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}")
    b, co, t = x.shape
    ci = params["proj_w"].shape[0]
    if depth < 1 or t % (2 ** (depth - 1)):
        raise ValueError(f"fused_uconv_block: T={t} not divisible by 2**(depth-1), depth={depth}")
    ps = _checked_params(x, params, depth)
    lib = _build.load_kernels()
    bf16 = int(pyramid_dtype == torch.bfloat16)
    out = _build.launch("fused_uconv_block", lib, "uconv_block_forward", x, ps,
                        lib.uconv_workspace_floats(b, co, ci, t, depth, bf16),
                        b, co, ci, t, depth, ctypes.c_float(EPS), bf16)
    fused_uconv_block.launches += 1
    if bf16:
        fused_uconv_block.launches_bf16_pyramid += 1
    fused_uconv_block.ladder_levels_tiled += _tiled_levels(lib, b * ci, t, depth)
    fused_uconv_block.gemm_wide_launches += _wide_gemms(lib, co, ci)
    return out


# launches of the kernel, all of them and those with a bf16 pyramid; the
# ladder levels they ran with more than one time tile a row; the 1x1
# products they ran on the wide GEMM
fused_uconv_block.launches = 0
fused_uconv_block.launches_bf16_pyramid = 0
fused_uconv_block.ladder_levels_tiled = 0
fused_uconv_block.gemm_wide_launches = 0


@functools.lru_cache(maxsize=None)
def _wide_gemms(lib, co: int, ci: int) -> int:
    """GEMM launches of a call on the wide route, by the library's own
    chooser: the proj product (Ci, Co) and the res product (Co, Ci)."""
    return lib.gemm_wide(ci, co) + lib.gemm_wide(co, ci)


def ladder_tiles(lib, rows: int, tout: int) -> tuple:
    """(time tiles a row, rows a warp, tile) of a ladder level, from the
    library's own chooser (``ladder_tiles`` in csrc/uconv.cu)."""
    warp_rows, tile = ctypes.c_int(), ctypes.c_int()
    tiles = lib.ladder_tiles(rows, tout, ctypes.byref(warp_rows), ctypes.byref(tile))
    return tiles, warp_rows.value, tile.value


@functools.lru_cache(maxsize=None)
def _tiled_levels(lib, rows: int, t: int, depth: int) -> int:
    """Ladder levels of a call that run with more than one time tile a row."""
    return sum(ladder_tiles(lib, rows, t >> k)[0] > 1 for k in range(depth))


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
