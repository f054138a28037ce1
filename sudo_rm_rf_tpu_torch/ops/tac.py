"""TAC, GroupComm SuDoRM-RF v2's transform-average-concatenate across the
channel groups, over x (B, G, n, T) with a ``groupcomm_sudormrf.TAC``
module's params. Two forms of one function:

* :func:`tac_plain` — the bandwidth-shaped arithmetic in plain torch
  (the training, int8, CPU and bf16 paths; ``_tac_fast`` calls it);
* :func:`fused_tac` — the wrapper of the hand-written Hopper kernel
  ``csrc/tac.cu``: forward only, fp32 in and out, groups of at most
  ``TAC_MAX_N`` channels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sudo_rm_rf_tpu_torch.ops import _build
from sudo_rm_rf_tpu_torch.ops.norm import glob_ln
from sudo_rm_rf_tpu_torch.ops.uconv import EPS

# the widest group the kernel takes (MAX_N in csrc/tac.cu)
TAC_MAX_N = 32


def tac_plain(tac, x, matmuls=None):
    """TAC over (B, G, N, T) as explicit channel matmuls.

    Bandwidth-shaped rewrite of the module's math (same values): instead of
    broadcasting the group mean to (B, G, H, T) and concatenating to
    (B, G, 2H, T) before the output linear, split W_out = [W_oy | W_om]
    along its input axis and compute W_oy y + (W_om m)[:, None]: the mean
    branch stays (B, H, T) until the final add.

    matmuls: optional (mm_in, mm_mean, mm_out) channel-matmul hooks, each
    ``mm(w (O, C), v (B', C, T))``.

    Runs in x's dtype (bf16 with fp32 GlobLN statistics, or fp32); weights
    and biases in another dtype are cast to it, as JAX promotes a narrower
    weight (a 'kernel' serving copy holds bf16-rounded weights in fp32).
    """
    b, g, n, t = x.shape
    dt = x.dtype
    mm_in, mm_mean, mm_out = matmuls if matmuls is not None else (torch.matmul,) * 3

    def prelu(act, v):
        return torch.where(v >= 0, v, act.weight[0] * v)

    lin_in, act_in = tac.TAC_input
    lin_mean, act_mean = tac.TAC_mean
    lin_out, act_out = tac.TAC_output
    y = mm_in(lin_in.weight.to(dt), x.reshape(b * g, n, t))
    h = y.shape[1]
    y = prelu(act_in, y.reshape(b, g, h, t) + lin_in.bias.to(dt)[None, None, :, None])
    mean = y.mean(dim=1)
    mean = prelu(act_mean, mm_mean(lin_mean.weight.to(dt), mean)
                 + lin_mean.bias.to(dt)[None, :, None])
    w_out = lin_out.weight.to(dt)  # (N, 2H)
    out = (
        mm_out(w_out[:, :h], y.reshape(b * g, h, t)).reshape(b, g, n, t)
        + torch.matmul(w_out[:, h:], mean)[:, None]
        + lin_out.bias.to(dt)[None, None, :, None]
    )
    out = prelu(act_out, out)
    out = glob_ln(out.reshape(b * g, n, t), tac.TAC_norm.gamma, tac.TAC_norm.beta)
    return x + out.reshape(b, g, n, t)


def _checked_params(tac, x) -> list:
    """The module's params in the order of ``tac_forward``'s arguments, for
    x (B, G, n, T), read as fp32 and checked by :func:`_build.check_params`."""
    (lin_in, act_in), (lin_mean, act_mean), (lin_out, act_out) = (
        tac.TAC_input, tac.TAC_mean, tac.TAC_output)
    n, h = x.shape[2], 3 * x.shape[2]
    return _build.check_params("fused_tac", x, {
        "w_in": lin_in.weight, "b_in": lin_in.bias, "s_in": act_in.weight,
        "w_mean": lin_mean.weight, "b_mean": lin_mean.bias, "s_mean": act_mean.weight,
        "w_out": lin_out.weight, "b_out": lin_out.bias, "s_out": act_out.weight,
        "gamma": tac.TAC_norm.gamma, "beta": tac.TAC_norm.beta,
    }, {"w_in": (h, n), "b_in": (h,), "s_in": (1,), "w_mean": (h, h), "b_mean": (h,),
        "s_mean": (1,), "w_out": (n, 2 * h), "b_out": (n,), "s_out": (1,), "gamma": (n,),
        "beta": (n,)}, convert=True)


@functools.lru_cache(maxsize=None)
def _work(lib, b: int, g: int, t: int) -> tuple:
    """(scratch floats, launches) of one call at this shape."""
    return lib.tac_workspace_floats(b, g, t), lib.tac_launches(t)


def fused_tac(tac, x):
    """Run TAC. x: (B, G, n, T) fp32, 1 <= n <= ``TAC_MAX_N``; returns (B,
    G, n, T) fp32. Params in another dtype are read as fp32, as
    :func:`tac_plain` casts them to x's.

    On a CUDA tensor this launches the Hopper kernel (``csrc/tac.cu``: two
    launches, three where a (batch, group) has more tiles than one launch
    merges) or raises; on a CPU tensor it runs :func:`tac_plain`. Forward
    only: on a CUDA tensor it raises where autograd would need a gradient.
    """
    if x.device.type == "cpu":
        return tac_plain(tac, x)
    if x.device.type != "cuda":
        raise ValueError(f"fused_tac: unsupported device {x.device}")
    if x.dtype != torch.float32 or x.ndim != 4 or not x.is_contiguous():
        raise ValueError(
            f"fused_tac: x must be a contiguous 4-D float32 tensor, got {x.dtype} "
            f"{tuple(x.shape)} contiguous={x.is_contiguous()}")
    b, g, n, t = x.shape
    if not 1 <= n <= TAC_MAX_N:
        raise ValueError(f"fused_tac: {n} channels a group, the kernel takes 1 to {TAC_MAX_N}")
    params = _checked_params(tac, x)
    lib = _build.load_kernels()
    ws, launches = _work(lib, b, g, t)
    out = _build.launch("fused_tac", lib, "tac_forward", x, params, ws, b, g, n, t,
                        ctypes.c_float(EPS))
    fused_tac.launches += launches
    return out


# launches of the kernel's passes (two a call, three with the fold)
fused_tac.launches = 0
