"""Exact long-form separation: one recording in a single pass with the TIME
axis split into shards (counterpart of
``sudo_rm_rf_tpu/inference/sequence_parallel.py``).

Overlap-add (``inference/overlap_add.py``) windows a long recording into
chunks; this module separates it exactly. The waveform is cut into
contiguous time shards, each shard runs the whole network on its own frames
plus a halo from each neighbour, and the result equals the unsharded
forward up to float reduction order (no windowing, no source realignment
between chunks).

How each op family is distributed (the JAX module's scheme, unchanged):

* **Convs and the ladder** — halo recompute: every shard receives
  ``halo_frames`` encoder frames of raw samples from each neighbour (one
  halo exchange), runs the network on ``owned + 2 * halo`` frames and crops
  back to ``owned``. The halo is the network's receptive-field radius
  (:func:`default_halo_frames`, :func:`causal_halo_frames`).
* **GlobLN** — each shard sums x and x^2 over its OWNED frames only, and
  the sums are all-reduced: exact global statistics, applied to every local
  frame.
* **Boundaries** — frames outside the global sequence are masked to zero
  before every spatial conv (masks from the shard's global offset), so the
  edge shards reproduce the unsharded zero padding. The halo exchange leaves
  zeros where a shard has no neighbour: the global zero pad of the samples.
* **Attention** (attentive v1/v2) — queries stay local; keys and values are
  one all-gather of every shard's owned frames at the deepest ladder level.

Shards run on a communicator: :class:`LocalShards` holds n shards in one
process (a checking device, see its docstring), :class:`DistributedShards`
one shard a rank of a ``torch.distributed`` group. Tensors inside a shard
body are (local shards x B, ...), shard-major.

Alignment: every shard owns a multiple of ``(enc_kernel_size // 2) *
2**depth`` samples, so frame counts stay divisible through the stride-2
ladder and every shard starts on an even frame at every level.

With one rank, a CUDA input and an Improved or GroupComm model,
:class:`SequenceParallelSeparator` runs the serving forward through the
U-ConvBlock kernel (K1) on the padded signal instead, in fp32 or under a
``compute_dtype``: at one shard the two are the same function.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from sudo_rm_rf_tpu_torch import ops
from sudo_rm_rf_tpu_torch.losses import mixture_consistency
from sudo_rm_rf_tpu_torch.models.attentive import AttentiveSuDORMRFBase
from sudo_rm_rf_tpu_torch.models.causal_sudormrf import CausalSuDORMRF, causal_mask
from sudo_rm_rf_tpu_torch.models.fast_inference import (
    _dtype,
    cast_model,
    groupcomm_forward_fast,
    improved_forward_fast,
)
from sudo_rm_rf_tpu_torch.models.groupcomm_sudormrf import GroupCommSuDORMRF
from sudo_rm_rf_tpu_torch.models.improved_sudormrf import SuDORMRFImproved
from sudo_rm_rf_tpu_torch.ops.uconv import EPS, dw_conv_s1, dw_conv_s2, params_from_module

SEQ_TYPES = ("relu", "groupcomm_v2", "causal", "attention", "attention_v2")
# the model types whose one-rank pass may run through K1
KERNEL_TYPES = ("relu", "groupcomm_v2")
IMPLS = ("kernel", "fma")


# ---------------------------------------------------------------------------
# communicators
# ---------------------------------------------------------------------------


class LocalShards:
    """``n`` time shards held as the leading (shard-major) part of the batch
    axis of one tensor, in one process: the counterpart of the JAX tests'
    virtual 8-device CPU mesh.

    It is a means of checking the n-shard algorithm (on the CPU without
    spawning processes, or on one card), not a way to spread work: every
    shard runs in this process, on this device. ``LocalShards(1)`` is the
    plain one-process communicator.

    The collectives become tensor ops: a sum over the shard axis, a shift
    along it with zero ends, and a reshape that lays the shards end to end.
    """

    def __init__(self, n: int = 1):
        if n < 1:
            raise ValueError(f"LocalShards needs n >= 1, got {n}")
        self.world = n

    def rank(self, device=None) -> torch.Tensor:
        """Global shard index of each local shard, (n,) int64."""
        return torch.arange(self.world, device=device)

    def all_reduce_sum(self, v: torch.Tensor) -> torch.Tensor:
        """(n*X, ...) -> (n*X, ...): each shard's rows replaced by the sum
        over the shards."""
        s = v.reshape(self.world, -1, *v.shape[1:]).sum(dim=0)
        return s.expand(self.world, *s.shape).reshape(v.shape)

    def halo_exchange(self, x: torch.Tensor, halo: int) -> torch.Tensor:
        """(n*B, L) -> (n*B, halo + L + halo): each shard flanked by its
        neighbours' edge samples, zeros where it has none."""
        xs = x.reshape(self.world, -1, x.shape[-1])
        z = xs.new_zeros((1, xs.shape[1], halo))
        left = torch.cat([z, xs[:-1, :, -halo:]], dim=0)
        right = torch.cat([xs[1:, :, :halo], z], dim=0)
        return torch.cat([left, xs, right], dim=-1).reshape(x.shape[0], -1)

    def all_gather(self, v: torch.Tensor) -> torch.Tensor:
        """(n*B, C, l) -> (B, C, n*l): the shards laid end to end in shard
        order, one copy."""
        b = v.shape[0] // self.world
        g = v.reshape(self.world, b, *v.shape[1:])
        return g.permute(1, 2, 0, 3).reshape(b, v.shape[1], -1)


class DistributedShards:
    """One time shard a rank of a ``torch.distributed`` process group
    (NCCL across GPUs, gloo on the CPU).

    The halo is one ``batch_isend_irecv`` with each existing neighbour (a
    rank with no neighbour on a side posts nothing there and keeps zeros),
    GlobLN sums one ``all_reduce``, the attentive k/v and the output one
    ``all_gather_into_tensor``. NCCL cannot place two ranks on one GPU: ranks
    that share a card run gloo, which takes CUDA tensors in ``all_reduce``
    only, so over gloo the halo and the gathers of a CUDA tensor go through
    the host.
    """

    def __init__(self, group=None):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("DistributedShards: torch.distributed is not initialized")
        self.group = group
        self.world = dist.get_world_size(group)
        self._rank = dist.get_rank(group)
        self._via_host = dist.get_backend(group) == "gloo"

    def rank(self, device=None) -> torch.Tensor:
        return torch.tensor([self._rank], device=device)

    def _peer(self, r: int) -> int:
        import torch.distributed as dist

        return r if self.group is None else dist.get_global_rank(self.group, r)

    def all_reduce_sum(self, v: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        v = v.contiguous().clone()
        dist.all_reduce(v, group=self.group)
        return v

    def halo_exchange(self, x: torch.Tensor, halo: int) -> torch.Tensor:
        import torch.distributed as dist

        if self._via_host and x.is_cuda:
            return self.halo_exchange(x.cpu(), halo).to(x.device)
        left = x.new_zeros((x.shape[0], halo))
        right = x.new_zeros((x.shape[0], halo))
        p2p = []
        if self._rank > 0:
            peer = self._peer(self._rank - 1)
            p2p += [dist.P2POp(dist.isend, x[:, :halo].contiguous(), peer, self.group),
                    dist.P2POp(dist.irecv, left, peer, self.group)]
        if self._rank < self.world - 1:
            peer = self._peer(self._rank + 1)
            p2p += [dist.P2POp(dist.isend, x[:, -halo:].contiguous(), peer, self.group),
                    dist.P2POp(dist.irecv, right, peer, self.group)]
        if p2p:
            for req in dist.batch_isend_irecv(p2p):
                req.wait()
        return torch.cat([left, x, right], dim=-1)

    def all_gather(self, v: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        if self._via_host and v.is_cuda:
            return self.all_gather(v.cpu()).to(v.device)
        v = v.contiguous()
        out = v.new_empty((self.world * v.shape[0], *v.shape[1:]))
        dist.all_gather_into_tensor(out, v, group=self.group)
        return LocalShards(self.world).all_gather(out)


def make_seq_comm():
    """The communicator over every rank of a ``torch.distributed`` launch
    (JAX's ``make_seq_mesh()`` over every device): a :class:`DistributedShards`
    of the default group, or ``LocalShards(1)`` in one process."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return DistributedShards()
    return LocalShards(1)


# ---------------------------------------------------------------------------
# halos, masks, GlobLN
# ---------------------------------------------------------------------------


def default_halo_frames(num_blocks: int, depth: int) -> int:
    """Receptive-field radius of the network in encoder frames, rounded up.

    Per U-ConvBlock the down ladder reaches +-(2 + sum_{k=1..D-1} 2*2^(k-1))
    = 2^D frames (k=5 'same' convs, stride 2); the upsample-add pass grows
    nothing. Encoder/decoder add +-2 frames. Rounded up to a multiple of
    2^(depth-1) to keep halo frame counts divisible through the ladder.
    """
    r = num_blocks * (2 ** depth) + 4
    q = 2 ** (depth - 1)
    return -(-r // q) * q


def causal_halo_frames(num_blocks: int, depth: int) -> int:
    """Receptive-field radius of the CAUSAL model in encoder frames.

    The causal ladder uses k=21 'same' convs whose future taps are weight-
    masked, so the reach is one-sided: 10 frames at level 0 plus 10*2^k for
    each stride-2 level -> 10*(2^depth - 1) per block, + encoder/decoder
    slack. A symmetric halo of this radius is used (the future side is cheap
    and keeps the shard layout shared with the other families). Rounded up
    to a multiple of 2^(depth-1).
    """
    r = num_blocks * 10 * (2 ** depth) + 8
    q = 2 ** (depth - 1)
    return -(-r // q) * q


def _owned_sums(v: torch.Tensor, owned, level: int = 0):
    """fp32 (sum, sum of squares) of v's owned frames at ladder ``level``
    over every axis but the first, as (N, 2)."""
    s, length = owned[0] >> level, owned[1] >> level
    o32 = v[..., s : s + length].float().reshape(v.shape[0], -1)
    return torch.stack([o32.sum(dim=1), (o32 * o32).sum(dim=1)], dim=1)


def _moments(sums: torch.Tensor, count: int):
    """(mean, rsqrt(var + eps)) from all-reduced (sum, sum of squares)."""
    mean = sums[..., 0] / count
    var = torch.clamp(sums[..., 1] / count - mean * mean, min=0.0)
    return mean, torch.rsqrt(var + EPS)


def _seq_glob_ln(x, gamma, beta, owned, comm):
    """GlobLN of a (N, C, T_local) shard with exact global statistics: sums
    over the owned frames (fp32), all-reduced, applied to every local frame
    (halo included); scale and shift cast back to x's dtype."""
    sums = comm.all_reduce_sum(_owned_sums(x, owned))
    mean, inv = _moments(sums, x.shape[1] * owned[1] * comm.world)
    g32 = gamma.float()[None, :, None]
    sc = (g32 * inv[:, None, None]).to(x.dtype)
    sh = (beta.float()[None, :, None] - g32 * (inv * mean)[:, None, None]).to(x.dtype)
    return sc * x + sh


def _level_masks(depth, n_rows, f_local, owned_f, halo_frames, t_f_global, comm, dtype,
                 device):
    """Per-ladder-level (N, 1, F_k) masks zeroing frames outside the global
    sequence; N = local shards x n_rows, shard-major."""
    g_start = comm.rank(device) * owned_f - halo_frames
    masks = []
    for k in range(depth):
        idx = (g_start >> k)[:, None] + torch.arange(f_local >> k, device=device)
        m = (idx >= 0) & (idx < (t_f_global >> k))
        masks.append(m.to(dtype).repeat_interleave(n_rows, dim=0)[:, None, :])
    return masks


def _prelu(act, v):
    w = act.weight
    slope = w[0] if w.shape[0] == 1 else w.reshape((1, -1) + (1,) * (v.ndim - 2))
    return torch.where(v >= 0, v, slope * v)


def _lin_cf(weight, bias, v):
    """A 1x1 conv / Linear over the channel axis of (N, C, T)."""
    return torch.matmul(weight, v) + bias[None, :, None]


# ---------------------------------------------------------------------------
# Improved SuDoRM-RF
# ---------------------------------------------------------------------------


def _ladder_upsum(cur, dw_w, dw_b, depth, masks, stats):
    """The folded ladder and upsample-sum shared by the Improved and
    GroupComm blocks: level k's input is (a * prev + b) * mask (each GlobLN
    folded into the next conv), ``stats(o, k, level) -> (a, b)``."""
    a, bb = 1.0, 0.0
    raw, folds = [], []
    for k in range(depth):
        x_in = (a * cur + bb) * masks[k if k == 0 else k - 1]
        o = (dw_conv_s1 if k == 0 else dw_conv_s2)(x_in, dw_w[k])
        o = o + dw_b[k][None, :, None]
        a, bb = stats(o, k)
        raw.append(o)
        folds.append((a, bb))
        cur = o
    a, bb = folds[-1]
    acc = a * raw[-1] + bb
    for k in range(depth - 2, -1, -1):
        a, bb = folds[k]
        acc = (a * raw[k] + bb) + ops.upsample_nearest_2x(acc)
    return acc


def _uconv_block_fma_seq(x, kp, depth, masks, owned0, comm):
    """``ops.uconv.uconv_block_fma`` with time-sharded semantics: GlobLN
    statistics over owned frames, all-reduced; ``masks[k]`` multiply every
    spatial conv's input."""
    ci = kp["proj_w"].shape[0]
    y = _lin_cf(kp["proj_w"], kp["proj_b"], x)
    y = _seq_glob_ln(y, kp["proj_g"], kp["proj_beta"], owned0, comm)
    y = torch.where(y >= 0, y, kp["proj_slope"] * y)

    def stats(o, k):
        sums = comm.all_reduce_sum(_owned_sums(o, owned0, k))
        mean, inv = _moments(sums, ci * (owned0[1] >> k) * comm.world)
        g = kp["dw_g"][k].float()[None, :, None]
        be = kp["dw_beta"][k].float()[None, :, None]
        a = g * inv[:, None, None]
        return a.to(o.dtype), (be - a * mean[:, None, None]).to(o.dtype)

    acc = _ladder_upsum(y, kp["dw_w"], kp["dw_b"], depth, masks, stats)
    acc = _seq_glob_ln(acc, kp["final_g"], kp["final_beta"], owned0, comm)
    acc = torch.where(acc >= 0, acc, kp["final_slope"] * acc)
    return _lin_cf(kp["res_w"], kp["res_b"], acc) + x


def _encode_seq(model, xloc, masks, owned0, comm):
    """Encoder (masked to the global range), GlobLN and bottleneck of the
    Improved-style models: (x, the pre-norm encoder features s)."""
    half = model.enc_kernel_size // 2
    dt = xloc.dtype
    s = ops.conv1d(xloc, model.encoder.weight.to(dt), stride=half, padding=half) * masks[0]
    x = _seq_glob_ln(s, model.ln.gamma, model.ln.beta, owned0, comm)
    x = _lin_cf(model.bottleneck.weight[:, :, 0].to(dt), model.bottleneck.bias.to(dt), x)
    return x, s


def _decode_seq(model, x, s, masks, n_out):
    """Mask head (PReLU, 1x1, ReLU, times s) and decoder over masked frames."""
    half = model.enc_kernel_size // 2
    prelu, mask_conv = model.mask_net
    x = _prelu(prelu, x)
    x = _lin_cf(mask_conv.weight[:, :, 0], mask_conv.bias, x)
    b = x.shape[0]
    x = torch.relu(x.reshape(b, n_out, model.enc_num_basis, -1)) * s[:, None]
    x = x * masks[0][:, None]
    return ops.conv_transpose1d(
        x.reshape(b, n_out * model.enc_num_basis, -1), model.decoder.weight,
        stride=half, padding=half, output_padding=half - 1)


def _improved_body(model, xloc, masks, owned0, comm):
    x, s = _encode_seq(model, xloc, masks, owned0, comm)
    for blk in model.sm:
        x = _uconv_block_fma_seq(x, params_from_module(blk), model.upsampling_depth, masks,
                                 owned0, comm)
    return _decode_seq(model, x, s, masks, model.num_sources)


# ---------------------------------------------------------------------------
# GroupComm v2
# ---------------------------------------------------------------------------


def _tac_seq(tac, x, owned0, comm):
    """``_tac_fast`` (bandwidth-shaped TAC) with its final GlobLN's
    statistics all-reduced; TAC is pointwise in time, so it consumes no
    halo. x: (N, G, n, T)."""
    b, g, n, t = x.shape
    dt = x.dtype
    lin_in, act_in = tac.TAC_input
    lin_mean, act_mean = tac.TAC_mean
    lin_out, act_out = tac.TAC_output
    y = torch.matmul(lin_in.weight.to(dt), x.reshape(b * g, n, t))
    h = y.shape[1]
    y = _prelu(act_in, y.reshape(b, g, h, t) + lin_in.bias.to(dt)[None, None, :, None])
    mean = _prelu(act_mean, _lin_cf(lin_mean.weight.to(dt), lin_mean.bias.to(dt),
                                    y.mean(dim=1)))
    w_out = lin_out.weight.to(dt)
    out = (torch.matmul(w_out[:, :h], y.reshape(b * g, h, t)).reshape(b, g, n, t)
           + torch.matmul(w_out[:, h:], mean)[:, None]
           + lin_out.bias.to(dt)[None, None, :, None])
    out = _prelu(act_out, out)
    out = _seq_glob_ln(out.reshape(b * g, n, t), tac.TAC_norm.gamma, tac.TAC_norm.beta,
                       owned0, comm)
    return x + out.reshape(b, g, n, t)


def _gc_block_seq(x, kp, depth, g, masks, owned0, comm):
    """``gc_uconv_block_fma_merged`` with time-sharded semantics: per
    (batch, group) GlobLN statistics over owned frames, all-reduced; masks
    on every spatial conv input."""
    b, c_out, t = x.shape
    out_pg = c_out // g
    in_pg = kp["proj_w"].shape[0]
    c_in = g * in_pg

    def grouped_stats(o, gamma, beta, level):
        """per-(row, group) statistics as merged (N, C_in, 1) scale/shift."""
        sums = _owned_sums(o.reshape(b * g, in_pg, -1), owned0, level)
        mean, inv = _moments(comm.all_reduce_sum(sums), in_pg * (owned0[1] >> level)
                             * comm.world)
        mean, inv = mean.reshape(b, g, 1, 1), inv.reshape(b, g, 1, 1)
        a = gamma.float()[None, None, :, None] * inv
        sh = beta.float()[None, None, :, None] - a * mean
        return a.reshape(b, c_in, 1).to(o.dtype), sh.reshape(b, c_in, 1).to(o.dtype)

    y = torch.matmul(kp["proj_w"], x.reshape(b * g, out_pg, t)).reshape(b, g, in_pg, t)
    y = (y + kp["proj_b"][None, None, :, None]).reshape(b, c_in, t)
    a, sh = grouped_stats(y, kp["proj_g"], kp["proj_beta"], 0)
    y = a * y + sh
    y = torch.where(y >= 0, y, kp["proj_slope"] * y)

    acc = _ladder_upsum(
        y, kp["dw_w"].repeat(1, g, 1), kp["dw_b"].repeat(1, g), depth, masks,
        lambda o, k: grouped_stats(o, kp["dw_g"][k], kp["dw_beta"][k], k))
    a, sh = grouped_stats(acc, kp["final_g"], kp["final_beta"], 0)
    acc = a * acc + sh
    acc = torch.where(acc >= 0, acc, kp["final_slope"] * acc)
    out = torch.matmul(kp["res_w"], acc.reshape(b * g, in_pg, t)).reshape(b, g, out_pg, t)
    return (out + kp["res_b"][None, None, :, None]).reshape(b, c_out, t) + x


def _groupcomm_body(model, xloc, masks, owned0, comm):
    x, s = _encode_seq(model, xloc, masks, owned0, comm)
    b, c, t = x.shape
    g = model.group_size
    for blk in model.sm:
        y = _tac_seq(blk.TAC, x.reshape(b, g, c // g, t), owned0, comm)
        x = _gc_block_seq(y.reshape(b, c, t), params_from_module(blk.UBlock),
                          model.upsampling_depth, g, masks, owned0, comm)
    return _decode_seq(model, x, s, masks, model.num_sources)


# ---------------------------------------------------------------------------
# causal v3
# ---------------------------------------------------------------------------


def _cconv(conv, v):
    """A ``CausalConv1d``: its weight causally masked (k >= 3), with the
    module's stride, padding and groups."""
    w = conv.weight
    if w.shape[-1] >= 3:
        w = w * causal_mask(w.shape[-1]).to(w)
    return ops.conv1d(v, w, conv.bias, stride=conv.stride, padding=conv.padding,
                      groups=conv.groups)


def _causal_body(model, xloc, masks, owned0, comm):
    """Norm-free: no collective statistics; the halo exchange is the only
    communication. Out-of-global frames are zero-masked before every
    spatial conv."""
    half = model.enc_kernel_size // 2
    depth = model.upsampling_depth
    x = _cconv(model.encoder, xloc) * masks[0]
    x = _cconv(model.bottleneck, x)
    for blk in model.sm:
        residual = x
        cur = _prelu(blk.proj_1x1.act, _cconv(blk.proj_1x1.conv, x))
        pyramid = []
        for k in range(depth):
            sub = blk.spp_dw[k]
            cur = _prelu(sub.act, _cconv(sub.conv, cur * masks[k if k == 0 else k - 1]))
            pyramid.append(cur)
        acc = pyramid[-1]
        for k in range(depth - 2, -1, -1):
            acc = pyramid[k] + ops.upsample_nearest_2x(acc)
        x = _cconv(blk.res_conv, acc) * blk.skipinit_gain + residual
    x = _cconv(model.mask_net[1], _prelu(model.mask_net[0], x))
    b = x.shape[0]
    x = _prelu(model.mask_nl_class, x.reshape(b, model.num_sources, model.enc_num_basis, -1))
    x = x * masks[0][:, None]
    return ops.conv_transpose1d(
        x.reshape(b, model.num_sources * model.enc_num_basis, -1), model.decoder.weight,
        stride=half, padding=half, output_padding=half - 1)


# ---------------------------------------------------------------------------
# attentive v1 / v2
# ---------------------------------------------------------------------------


def _pe_at(idx: torch.Tensor, d_model: int, dtype) -> torch.Tensor:
    """Sinusoidal positional encoding at GLOBAL frame indices idx (..., L)
    -> (..., L, d_model): even columns sin, odd columns cos, as
    ``models.attentive.sinusoidal_pe`` tabulates for 0..L-1 (out-of-global
    halo indices give values that the masks and the crop discard)."""
    pos = idx.float()[..., None]
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32, device=idx.device)
                    * (-math.log(10000.0) / d_model))
    ang = pos * div
    pe = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1)
    return pe.reshape(*idx.shape, -1).to(dtype)


def _frame_pe(x, owned, comm, d_model):
    """(N, T_local, d_model) encodings of a (N, C, T_local) shard's frames
    at their global indices."""
    n = comm.rank(x.device)
    idx = (n * owned[1] - owned[0])[:, None] + torch.arange(x.shape[-1], device=x.device)
    return _pe_at(idx, d_model, x.dtype).repeat_interleave(x.shape[0] // len(n), dim=0)


def _gather_owned(x, owned, comm):
    """Every shard's OWNED frames of a (N, C, T_local) tensor laid end to
    end: the exact global sequence (B, C, world * owned_len)."""
    s, length = owned
    return comm.all_gather(x[..., s : s + length].contiguous())


def _attend_global(q, k, v):
    """softmax(q k^T) v with q (N, Lq, H, D) local (already scaled) and k, v
    (B, L, H, D) global, N = local shards x B -> (N, Lq, H*D)."""
    b = k.shape[0]
    qs = q.reshape(-1, b, *q.shape[1:])
    attn = torch.softmax(torch.einsum("sblhd,bkhd->sbhlk", qs, k), dim=-1)
    out = torch.einsum("sbhlk,bkhd->sblhd", attn, v)
    return out.reshape(q.shape[0], q.shape[1], -1)


def _linear(lin, v):
    return torch.nn.functional.linear(v, lin.weight, lin.bias)


def _transformer_seq(layer, x, owned, comm):
    """``attentive.TransformerLayer`` (v2) under time sharding: q local,
    k/v the all-gathered owned frames, every GlobLN all-reduced."""
    mha = layer.mha
    h, d = mha.n_heads, mha.d_model
    xt = x.transpose(1, 2) + _frame_pe(x, owned, comm, x.shape[1])
    kv = _gather_owned(xt.transpose(1, 2), owned, comm).transpose(1, 2)  # (B, L, C)

    def heads(lin, v):
        return _linear(lin, v).reshape(v.shape[0], v.shape[1], h, d)

    att = _attend_global((1.0 / math.sqrt(d)) * heads(mha.Q_proj, xt),
                         heads(mha.K_proj, kv), heads(mha.V_proj, kv))
    xt = xt + _linear(mha.O_proj, att)
    y = _seq_glob_ln(xt.transpose(1, 2), layer.out_mha_norm.gamma, layer.out_mha_norm.beta,
                     owned, comm)
    ffn = layer.ffn
    f = _lin_cf(ffn.conv.weight[:, :, 0], ffn.conv.bias, y)
    f = _prelu(ffn.act, _seq_glob_ln(f, ffn.norm.gamma, ffn.norm.beta, owned, comm))
    return _seq_glob_ln(f + y, layer.out_norm.gamma, layer.out_norm.beta, owned, comm)


def _mha_norm_seq(layer, x, owned, comm):
    """``attentive.MHANormLayer`` (v1) under time sharding: the packed-qkv
    TorchMHA projects q locally and k/v from the gathered global sequence."""
    d = layer.att_dim
    mha = layer.mha
    h = mha.num_heads
    hd = d // h
    xt = _lin_cf(layer.in_linear.weight, layer.in_linear.bias, x)  # (N, A, T)
    xt = xt + _frame_pe(x, owned, comm, d).transpose(1, 2)
    xt = _seq_glob_ln(xt, layer.in_norm.gamma, layer.in_norm.beta, owned, comm)
    w, bvec = mha.in_proj_weight, mha.in_proj_bias
    xt_cl = xt.transpose(1, 2)
    n, t_loc, _ = xt_cl.shape
    q = (torch.nn.functional.linear(xt_cl, w[:d], bvec[:d]).reshape(n, t_loc, h, hd)
         / math.sqrt(hd))
    kv_cl = _gather_owned(xt, owned, comm).transpose(1, 2)
    k, v = torch.nn.functional.linear(kv_cl, w[d:], bvec[d:]).split(d, dim=-1)
    b, t_glob = kv_cl.shape[:2]
    att = _attend_global(q, k.reshape(b, t_glob, h, hd), v.reshape(b, t_glob, h, hd))
    att = _linear(mha.out_proj, att)
    y = xt + _seq_glob_ln(att.transpose(1, 2), layer.out_norm1.gamma, layer.out_norm1.beta,
                          owned, comm)
    out = _lin_cf(layer.out_linear.weight, layer.out_linear.bias, y)
    out = _seq_glob_ln(out, layer.out_norm2.gamma, layer.out_norm2.beta, owned, comm)
    return _prelu(layer.act, out)


def _attentive_block_seq(blk, x, depth, masks, owned0, comm):
    """``attentive.AttentiveUConvBlock`` (v1/v2) with time-sharded
    semantics: halo-recompute convs with out-of-global masks, all-reduced
    GlobLN statistics, and exact global attention at the deepest level."""
    ci = blk.proj_1x1.conv.weight.shape[0]
    residual = x
    y = _lin_cf(blk.proj_1x1.conv.weight[:, :, 0], blk.proj_1x1.conv.bias, x)
    y = _seq_glob_ln(y, blk.proj_1x1.norm.gamma, blk.proj_1x1.norm.beta, owned0, comm)
    cur = _prelu(blk.proj_1x1.act, y)
    pyramid = []
    for k in range(depth):
        sub = blk.spp_dw[k]
        cur = ops.conv1d(cur * masks[k if k == 0 else k - 1], sub.conv.weight, sub.conv.bias,
                         stride=1 if k == 0 else 2, padding=2, groups=ci)
        cur = _seq_glob_ln(cur, sub.norm.gamma, sub.norm.beta,
                           (owned0[0] >> k, owned0[1] >> k), comm)
        pyramid.append(cur)
    lvl = depth - 1
    owned_l = (owned0[0] >> lvl, owned0[1] >> lvl)
    layer = _mha_norm_seq if blk.variant == "v1" else _transformer_seq
    acc = layer(blk.attention, pyramid[-1], owned_l, comm)
    for k in range(depth - 2, -1, -1):
        acc = pyramid[k] + ops.upsample_nearest_2x(acc)
    norm = blk.final_norm
    acc = _prelu(norm.act, _seq_glob_ln(acc, norm.norm.gamma, norm.norm.beta, owned0, comm))
    return _lin_cf(blk.res_conv.weight[:, :, 0], blk.res_conv.bias, acc) + residual


def _attentive_body(model, xloc, masks, owned0, comm):
    x, s = _encode_seq(model, xloc, masks, owned0, comm)
    for blk in model.sm:
        x = _attentive_block_seq(blk, x, model.upsampling_depth, masks, owned0, comm)
    return _decode_seq(model, x, s, masks, model.num_sources)


# ---------------------------------------------------------------------------
# the public forwards
# ---------------------------------------------------------------------------


def _forward_seq(body, model, input_wav, comm, halo_frames, compute_dtype):
    """Shard (B, T) over ``comm``, exchange halos, run ``body`` on every
    shard, crop, and lay the shards end to end: (B, S, T) fp32 on every
    rank."""
    stride = model.enc_kernel_size // 2
    depth = model.upsampling_depth
    halo_s = halo_frames * stride
    b, t = input_wav.shape
    align = stride * 2 ** depth
    if t % (comm.world * align):
        raise ValueError(f"input length {t} is not a multiple of n_shards x (enc_kernel_size"
                         f"//2) x 2**depth = {comm.world * align}: pad it (or use "
                         "SequenceParallelSeparator)")
    if halo_frames % 2 ** (depth - 1):
        raise ValueError(f"halo_frames {halo_frames} is not a multiple of 2**(depth-1) = "
                         f"{2 ** (depth - 1)}")
    owned_s = t // comm.world
    if owned_s < halo_s:
        raise ValueError(
            f"per-shard length {owned_s} < halo {halo_s}: halos are exchanged "
            "with immediate neighbors only — pad the input or shrink halo_frames")
    model = cast_model(model, compute_dtype)
    dt = _dtype(compute_dtype) or model.encoder.weight.dtype
    ranks = comm.rank().tolist()
    x = torch.cat([input_wav[:, r * owned_s : (r + 1) * owned_s] for r in ranks]).to(dt)
    xloc = comm.halo_exchange(x, halo_s)[:, None, :]
    owned_f = owned_s // stride
    masks = _level_masks(depth, b, owned_f + 2 * halo_frames, owned_f, halo_frames,
                         comm.world * owned_f, comm, dt, x.device)
    est = body(model, xloc, masks, (halo_frames, owned_f), comm)
    return comm.all_gather(est[..., halo_s : halo_s + owned_s].float())


@torch.no_grad()
def improved_forward_seq(model, input_wav, comm, halo_frames: Optional[int] = None,
                         compute_dtype=None) -> torch.Tensor:
    """Time-sharded forward of a ``SuDORMRFImproved`` over ``comm``.
    input_wav (B, T), the whole recording on every rank, T a multiple of
    ``comm.world`` x (enc_kernel_size//2) x 2**depth
    (``SequenceParallelSeparator`` pads arbitrary lengths). Equals ``improved_forward_fast(impl="fma")`` on the
    same input up to float reduction order. Returns (B, S, T) fp32."""
    if halo_frames is None:
        halo_frames = default_halo_frames(model.num_blocks, model.upsampling_depth)
    return _forward_seq(_improved_body, model, input_wav, comm, halo_frames, compute_dtype)


@torch.no_grad()
def groupcomm_forward_seq(model, input_wav, comm, halo_frames: Optional[int] = None,
                          compute_dtype=None) -> torch.Tensor:
    """Time-sharded forward of a one-audio-channel ``GroupCommSuDORMRF``
    (TAC is pointwise in time: only the shared ladder consumes halo). Equals
    ``groupcomm_forward_fast(impl="fma_merged")`` on the same input."""
    if model.in_audio_channels != 1:
        raise ValueError("groupcomm_forward_seq takes in_audio_channels=1, as JAX's does")
    if halo_frames is None:
        halo_frames = default_halo_frames(model.num_blocks, model.upsampling_depth)
    return _forward_seq(_groupcomm_body, model, input_wav, comm, halo_frames, compute_dtype)


@torch.no_grad()
def causal_forward_seq(model, input_wav, comm, halo_frames: Optional[int] = None,
                       compute_dtype=None) -> torch.Tensor:
    """Time-sharded forward of a one-audio-channel ``CausalSuDORMRF``; equals
    the module's forward. Collective-free except the halo exchange."""
    if model.in_audio_channels != 1:
        raise ValueError("causal_forward_seq takes in_audio_channels=1, as JAX's does")
    if halo_frames is None:
        halo_frames = causal_halo_frames(model.num_blocks, model.upsampling_depth)
    return _forward_seq(_causal_body, model, input_wav, comm, halo_frames, compute_dtype)


def _v3_refusal(model_type: str) -> ValueError:
    return ValueError(
        f"sequence parallelism supports 'relu'/'groupcomm_v2'/'causal'/'attention'/"
        f"'attention_v2' (attention_v3 falls back to overlap-add: its shallowest "
        f"cross-attention resampler takes k/v at T/2 frames x C channels, so the "
        f"per-block gather would move ~C/2 floats per input sample — erasing the "
        f"per-shard memory win that is the point of time sharding), got {model_type!r}")


@torch.no_grad()
def attentive_forward_seq(model, input_wav, comm, halo_frames: Optional[int] = None,
                          compute_dtype=None) -> torch.Tensor:
    """Time-sharded forward of an attentive SuDoRM-RF v1 or v2; equals the
    module's forward. The attention at the deepest ladder level is exact
    (q local, k/v one all-gather of every shard's owned frames), not
    windowed. v3 is refused (see :func:`seq_model_type`)."""
    if model.variant not in ("v1", "v2"):
        raise _v3_refusal(f"attention_{model.variant}")
    if halo_frames is None:
        halo_frames = default_halo_frames(model.num_blocks, model.upsampling_depth)
    return _forward_seq(_attentive_body, model, input_wav, comm, halo_frames, compute_dtype)


def seq_model_type(model) -> str:
    """The model type name of a module sequence parallelism serves; raises
    ``ValueError`` for the others (attentive v3 with JAX's reason)."""
    if isinstance(model, SuDORMRFImproved):
        return "relu"
    if isinstance(model, GroupCommSuDORMRF):
        return "groupcomm_v2"
    if isinstance(model, CausalSuDORMRF):
        return "causal"
    if isinstance(model, AttentiveSuDORMRFBase):
        name = {"v1": "attention", "v2": "attention_v2"}.get(model.variant)
        if name is None:
            raise _v3_refusal(f"attention_{model.variant}")
        return name
    raise _v3_refusal(type(model).__name__)


_FORWARDS = {"relu": improved_forward_seq, "groupcomm_v2": groupcomm_forward_seq,
             "causal": causal_forward_seq, "attention": attentive_forward_seq,
             "attention_v2": attentive_forward_seq}


class SequenceParallelSeparator:
    """Separate one long mixture in a single exact pass.

    Complements ``OverlapAddSeparator``: no windowing or chunk-boundary
    source realignment; the output equals the unsharded model up to float
    reduction order.

    Args:
      model: a ``SuDORMRFImproved`` ("relu"), ``GroupCommSuDORMRF``
        ("groupcomm_v2"), ``CausalSuDORMRF`` ("causal") or attentive v1/v2
        ("attention", "attention_v2"); v3 raises with its reason. The input
        runs on the model's device.
      comm: the shard communicator (default ``LocalShards(1)``, one rank).
      compute_dtype: None (fp32) or e.g. ``"bfloat16"``, as the fast
        forwards take it; the model is cast once, for the route that runs.
      impl: "kernel" runs ``improved_forward_fast`` / ``groupcomm_forward_fast``
        with ``impl="kernel"`` (K1) on the padded signal, in any
        ``compute_dtype``; it raises with more than one shard, with another
        model type or on a CPU tensor. "fma" runs the shard body. None picks
        "kernel" where it applies, else "fma".

    Padded lengths fit the input exactly: eager PyTorch keeps no compiled
    program per shape, so the port needs none of JAX's shape buckets.

    After :meth:`separate`, ``route`` names the impl that ran.
    """

    def __init__(self, model, comm=None, halo_frames: Optional[int] = None,
                 input_normalize: bool = True, mixture_consistency: Optional[str] = None,
                 compute_dtype=None, impl: Optional[str] = None):
        self.model_type = seq_model_type(model)
        if impl not in (None, *IMPLS):
            raise ValueError(f"impl {impl!r} not in {IMPLS}")
        if mixture_consistency not in (None, "uniform", "magsq"):
            raise ValueError(f"mixture_consistency {mixture_consistency!r} not in "
                             "(None, 'uniform', 'magsq')")
        self.model = model
        self._cast = {}  # route -> the copy cast once for it
        self.comm = comm if comm is not None else LocalShards(1)
        self.depth = model.upsampling_depth
        self.enc_kernel_size = model.enc_kernel_size
        if halo_frames is not None:
            self.halo_frames = halo_frames
        elif self.model_type == "causal":
            self.halo_frames = causal_halo_frames(model.num_blocks, self.depth)
        else:
            self.halo_frames = default_halo_frames(model.num_blocks, self.depth)
        self.input_normalize = input_normalize
        self.mixture_consistency = mixture_consistency
        _dtype(compute_dtype)  # a bad dtype raises here, not at the first call
        self.compute_dtype = compute_dtype
        self.impl = impl
        self.route = None
        self._n = self.comm.world
        self._align = (self.enc_kernel_size // 2) * (2 ** self.depth)
        if impl == "kernel":
            self._check_kernel(None)

    def _check_kernel(self, x):
        why = (f"{self._n} shards" if self._n > 1
               else f"model type {self.model_type!r}" if self.model_type not in KERNEL_TYPES
               else "a CPU tensor" if x is not None and not x.is_cuda else None)
        if why is not None:
            raise ValueError(f"impl='kernel' runs K1 on one rank for "
                             f"{KERNEL_TYPES} on a CUDA tensor; got {why}")

    def _padded_len(self, t: int) -> int:
        per = -(-t // self._n)
        # halos come from immediate neighbors only: every shard must own at
        # least halo_samples (short inputs just get extra zero pad)
        per = max(per, self.halo_frames * (self.enc_kernel_size // 2))
        per = -(-per // self._align) * self._align
        return per * self._n

    def _pick(self, x) -> str:
        if self.impl == "kernel":
            self._check_kernel(x)
            return "kernel"
        if self.impl is None and x.is_cuda and self._n == 1 and self.model_type in KERNEL_TYPES:
            return "kernel"
        return "fma"

    def separate(self, mixture: np.ndarray) -> np.ndarray:
        """(T,) mixture -> (S, T) separated sources."""
        mixture = np.asarray(mixture, np.float32).reshape(-1)
        t = mixture.shape[0]
        if self.input_normalize:
            mean = float(mixture.mean())
            std = float(mixture.std(ddof=1)) if t > 1 else 1.0
            xn = (mixture - mean) / (std + 1e-9)
        else:
            mean, std = 0.0, 1.0
            xn = mixture
        padded = np.zeros(self._padded_len(t), np.float32)
        padded[:t] = xn
        device = next(self.model.parameters()).device
        x = torch.from_numpy(padded[None]).to(device)
        route = self._pick(x)
        if route not in self._cast:
            self._cast[route] = cast_model(self.model, self.compute_dtype,
                                           "kernel" if route == "kernel" else None)
        model = self._cast[route]
        with torch.no_grad():
            if route == "kernel":
                fast = (groupcomm_forward_fast if self.model_type == "groupcomm_v2"
                        else improved_forward_fast)
                est = fast(model, x[:, None], impl="kernel", compute_dtype=self.compute_dtype)
            else:
                est = _FORWARDS[self.model_type](model, x, self.comm, self.halo_frames,
                                                 self.compute_dtype)
            est = est[..., :t]
            if self.mixture_consistency is not None:
                est = mixture_consistency(est, x[:, None, :t], self.mixture_consistency)
        self.route = route
        return est[0].cpu().numpy() * std + mean
