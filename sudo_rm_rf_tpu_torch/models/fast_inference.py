"""Serving forwards of the Improved and GroupComm SuDoRM-RF (counterparts of
``sudo_rm_rf_tpu/models/fast_inference.py::improved_forward_fast`` and
``::groupcomm_forward_fast``).

Same math as the models' ``forward``, with every 1x1 conv as an explicit
channel matmul and each U-ConvBlock run by the form ``impl`` names. Forward
only, fp32.
"""

from __future__ import annotations

import torch

from sudo_rm_rf_tpu_torch import ops
from sudo_rm_rf_tpu_torch.models.groupcomm_sudormrf import _tac_fast, gc_uconv_block_fma_merged
from sudo_rm_rf_tpu_torch.ops.uconv import (
    fused_uconv_block,
    params_from_module,
    uconv_block_fma,
    uconv_block_reference,
)

_BLOCKS = {
    "kernel": fused_uconv_block,
    "fma": uconv_block_fma,
    "xla": uconv_block_reference,
}
GC_IMPLS = ("kernel", "fma_merged", "fma_bd", "fma", "xla")


def _encode(model, input_wav):
    """Pad, encode, GlobLN and bottleneck: (x (B, C, T'), the pre-norm
    encoder features s (B, N, T'), the input length)."""
    if input_wav.ndim == 2:
        input_wav = input_wav[:, None, :]
    in_len = input_wav.shape[-1]
    half = model.enc_kernel_size // 2
    x = ops.pad_to_multiple(input_wav, model.n_least_samples_req)
    x = ops.conv1d(x, model.encoder.weight, stride=half, padding=half)
    s = x
    x = ops.glob_ln(x, model.ln.gamma, model.ln.beta)
    # matmul keeps (B, C, T) contiguous, as the kernel requires
    x = (torch.matmul(model.bottleneck.weight[:, :, 0], x)
         + model.bottleneck.bias[None, :, None])
    return x, s, in_len


def _decode(model, x, s, in_len, n_out: int):
    """Mask head, masking of s and the decoder, cropped to ``in_len``:
    (B, n_out, in_len)."""
    half = model.enc_kernel_size // 2
    prelu, mask_conv = model.mask_net
    x = torch.where(x >= 0, x, prelu.weight[0] * x)
    x = torch.matmul(mask_conv.weight[:, :, 0], x) + mask_conv.bias[None, :, None]
    b = x.shape[0]
    x = torch.relu(x.reshape(b, n_out, model.enc_num_basis, -1))
    x = x * s[:, None, :, :]
    est = ops.conv_transpose1d(
        x.reshape(b, n_out * model.enc_num_basis, -1),
        model.decoder.weight, stride=half, padding=half,
        output_padding=half - 1,
    )
    return ops.unpad_to_length(est, in_len)


@torch.no_grad()
def improved_forward_fast(model, input_wav: torch.Tensor, impl: str = None) -> torch.Tensor:
    """model: a ``SuDORMRFImproved``; input_wav: (B, 1, T) or (B, T) fp32.

    impl: 'kernel' (the CUDA U-ConvBlock kernel; the default on a CUDA
    tensor), 'fma' (shifted multiply-adds with folded norms; the default on
    the CPU) or 'xla' (plain ops).
    """
    if impl is None:
        impl = "kernel" if input_wav.is_cuda else "fma"
    if impl not in _BLOCKS:
        raise ValueError(f"impl {impl!r} not in {sorted(_BLOCKS)}")
    block = _BLOCKS[impl]
    x, s, in_len = _encode(model, input_wav)
    for blk in model.sm:
        x = block(x, params_from_module(blk), model.upsampling_depth)
    return _decode(model, x, s, in_len, model.num_sources)


def _make_bd_mm(b: int, g: int):
    """Group-batched block-diagonal channel matmul hook: the G groups'
    shared (C/G -> O/G) projection as ONE product with the block-diagonal
    weight I_G (x) w of shape (G*O, G*C), over v viewed as (B, G*C, T).
    Exact up to reduction order: the inserted weights are 0.0.

    Returns a hook with the ``matmul(w (O, C), v (B*G, C, T))`` signature of
    :func:`gc_uconv_block_fma_merged` / :func:`_tac_fast`.
    """

    def bd_mm(w, v):
        o, c = w.shape
        t = v.shape[-1]
        w_bd = torch.kron(torch.eye(g, dtype=w.dtype, device=w.device), w)
        return torch.matmul(w_bd, v.reshape(b, g * c, t)).reshape(b * g, o, t)

    return bd_mm


@torch.no_grad()
def groupcomm_forward_fast(model, input_wav: torch.Tensor, impl: str = None) -> torch.Tensor:
    """model: a ``GroupCommSuDORMRF``; input_wav: (B, C_audio, T) or (B, T)
    fp32. Returns (B, S*C_audio, T) fp32.

    Each block is the bandwidth-shaped TAC (:func:`_tac_fast`) and then the
    shared U-ConvBlock in the form ``impl`` names:

    * 'kernel' (the default on a CUDA tensor): the CUDA U-ConvBlock kernel
      on the group-folded (B*G, C/G, T) layout, whose per-row GlobLN is
      then per (batch, group);
    * 'fma_merged' (the default on the CPU): groups merged into the channel
      axis (:func:`gc_uconv_block_fma_merged`);
    * 'fma_bd': 'fma_merged' with every shared per-group projection (TAC in
      and out, the block's proj and res) as one block-diagonal product
      (:func:`_make_bd_mm`);
    * 'fma': ``uconv_block_fma`` on the folded layout;
    * 'xla': ``uconv_block_reference`` on the folded layout.
    """
    if impl is None:
        impl = "kernel" if input_wav.is_cuda else "fma_merged"
    if impl not in GC_IMPLS:
        raise ValueError(f"impl {impl!r} not in {GC_IMPLS}")
    x, s, in_len = _encode(model, input_wav)
    b, c, t = x.shape
    g, depth = model.group_size, model.upsampling_depth
    bd_mm = _make_bd_mm(b, g) if impl == "fma_bd" else None
    tac_mms = (bd_mm, torch.matmul, bd_mm) if bd_mm is not None else None
    for blk in model.sm:
        y = _tac_fast(blk.TAC, x.reshape(b, g, c // g, t), matmuls=tac_mms)
        kp = params_from_module(blk.UBlock)
        if impl in ("fma_merged", "fma_bd"):
            x = gc_uconv_block_fma_merged(y.reshape(b, c, t), kp, depth, g, matmul=bd_mm)
        else:
            x = _BLOCKS[impl](y.reshape(b * g, c // g, t), kp, depth).reshape(b, c, t)
    return _decode(model, x, s, in_len, model.num_sources * model.in_audio_channels)
