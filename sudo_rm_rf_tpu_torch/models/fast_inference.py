"""Serving forwards of the Improved and GroupComm SuDoRM-RF (counterparts of
``sudo_rm_rf_tpu/models/fast_inference.py::improved_forward_fast`` and
``::groupcomm_forward_fast``).

Same math as the models' ``forward``, with every 1x1 conv as an explicit
channel matmul and each U-ConvBlock run by the form ``impl`` names. Forward
only. Input fp32; output fp32. ``compute_dtype`` (as JAX's): None runs in
fp32; ``"bfloat16"`` runs the params and the padded input in bf16 with fp32
GlobLN statistics, except that the CUDA kernel (``impl="kernel"``), as JAX's
Pallas kernel, computes in fp32 from the bf16-rounded params, so the stream
is fp32 from the first block on.
"""

from __future__ import annotations

import copy
import functools

import torch

from sudo_rm_rf_tpu_torch import ops
from sudo_rm_rf_tpu_torch.models.groupcomm_sudormrf import _tac_fast, gc_uconv_block_fma_merged
from sudo_rm_rf_tpu_torch.ops.tac import TAC_MAX_N
from sudo_rm_rf_tpu_torch.ops.uconv import (
    fused_uconv_block,
    params_from_module,
    uconv_block_fma,
    uconv_block_reference,
)
from sudo_rm_rf_tpu_torch.utils import tracing


def _kernel_block(x, kp, depth: int, pyramid_dtype=torch.float32):
    """K1 on x in fp32: JAX's Pallas kernel under bf16 computes from the
    bf16-rounded params and returns fp32. The params come in fp32 (a
    :func:`cast_model` copy for 'kernel' holds them rounded in fp32); others
    are upcast here."""
    kp = {k: v if v.dtype == torch.float32 else v.float() for k, v in kp.items()}
    return fused_uconv_block(x.float().contiguous(), kp, depth, pyramid_dtype)


_BLOCKS = {
    "kernel": _kernel_block,
    "fma": uconv_block_fma,
    "xla": uconv_block_reference,
}
GC_IMPLS = ("kernel", "fma_merged", "xla")


def _dtype(compute_dtype):
    """torch dtype of a ``compute_dtype`` (None, a name such as
    ``"bfloat16"``, or a torch dtype)."""
    if compute_dtype is None:
        return None
    dt = getattr(torch, compute_dtype) if isinstance(compute_dtype, str) else compute_dtype
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError(f"compute_dtype {compute_dtype!r} is not a floating dtype")
    return dt


def cast_model(model, compute_dtype, impl: str = None):
    """``model`` prepared for serving through ``impl`` in ``compute_dtype``:
    the model itself when it already is, else a copy (the caller's module is
    never cast in place). Cast once and pass the copy to serve without a
    cast per call.

    For 'kernel' the copy holds every param and buffer rounded to
    ``compute_dtype`` but stored in fp32, since K1 and the fp32 stream after
    it read them so (only the encoder casts its weights per call); for the
    other impls, and None, in ``compute_dtype``."""
    dt = _dtype(compute_dtype)
    if dt is None:
        return model
    tensors = list(model.parameters()) + list(model.buffers())
    if impl == "kernel":
        if getattr(model, "_rounded_to", None) == dt:
            return model
        memo = {id(v): v.detach().to(dt).float() for v in tensors}
        out = copy.deepcopy(model, memo)
        out._rounded_to = dt
        return out
    if all(v.dtype == dt for v in tensors):
        return model
    memo = {id(v): v.detach().to(dt) for v in tensors}
    return copy.deepcopy(model, memo)


def _encode(model, input_wav, dtype=None):
    """Pad, cast to ``dtype`` (None: as the model's weights), encode, GlobLN
    and bottleneck: (x (B, C, T'), the pre-norm encoder features s (B, N,
    T'), the input length)."""
    if input_wav.ndim == 2:
        input_wav = input_wav[:, None, :]
    in_len = input_wav.shape[-1]
    half = model.enc_kernel_size // 2
    x = ops.pad_to_multiple(input_wav, model.n_least_samples_req)
    x = x.to(dtype or model.encoder.weight.dtype)
    dt = x.dtype  # a 'kernel' copy's rounded fp32 weights are cast to it
    x = ops.conv1d(x, model.encoder.weight.to(dt), stride=half, padding=half)
    s = x
    x = ops.glob_ln(x, model.ln.gamma, model.ln.beta)
    # matmul keeps (B, C, T) contiguous, as the kernel requires
    x = (torch.matmul(model.bottleneck.weight[:, :, 0].to(dt), x)
         + model.bottleneck.bias.to(dt)[None, :, None])
    return x, s, in_len


def _decode(model, x, s, in_len, n_out: int):
    """Mask head, masking of s and the decoder, cropped to ``in_len``:
    (B, n_out, in_len) fp32. Runs in x's dtype: narrower weights are upcast
    (an fp32 stream after the kernel under bf16, as JAX promotes)."""
    half = model.enc_kernel_size // 2
    prelu, mask_conv = model.mask_net
    dt = x.dtype
    x = torch.where(x >= 0, x, prelu.weight[0] * x)
    x = torch.matmul(mask_conv.weight[:, :, 0].to(dt), x) + mask_conv.bias[None, :, None]
    b = x.shape[0]
    x = torch.relu(x.reshape(b, n_out, model.enc_num_basis, -1))
    x = x * s[:, None, :, :]
    est = ops.conv_transpose1d(
        x.reshape(b, n_out * model.enc_num_basis, -1),
        model.decoder.weight.to(x.dtype), stride=half, padding=half,
        output_padding=half - 1,
    )
    return ops.unpad_to_length(est, in_len).float()


def _block_fn(impl: str, pyramid_dtype):
    """The block form ``impl`` names (None for GroupComm's 'fma_merged',
    which its forward runs itself); ``pyramid_dtype`` is K1's (the 'kernel'
    impl's) level store, fp32 by default as JAX's kernel's."""
    if impl == "kernel":
        return functools.partial(_kernel_block, pyramid_dtype=pyramid_dtype)
    if pyramid_dtype != torch.float32:
        raise ValueError(f"pyramid_dtype {pyramid_dtype} is the kernel's: impl {impl!r} "
                         "has no pyramid store")
    return _BLOCKS.get(impl)


@torch.no_grad()
def improved_forward_fast(model, input_wav: torch.Tensor, impl: str = None,
                          compute_dtype=None, pyramid_dtype=torch.float32,
                          tp_mesh=None) -> torch.Tensor:
    """model: a ``SuDORMRFImproved``; input_wav: (B, 1, T) or (B, T) fp32.
    Returns (B, S, T) fp32.

    impl: 'kernel' (the CUDA U-ConvBlock kernel; the default on a CUDA
    tensor), 'fma' (shifted multiply-adds with folded norms; the default on
    the CPU) or 'xla' (plain ops).

    compute_dtype: None (fp32) or e.g. ``"bfloat16"``: the params (a cast
    copy, see :func:`cast_model`; pass one made for ``impl`` to cast once)
    and the padded input in that dtype, GlobLN statistics in fp32, the
    output fp32 (the module docstring says what 'kernel' does under it).

    pyramid_dtype: ``torch.float32`` (default) or ``torch.bfloat16``, the
    kernel's ladder store (``ops.uconv.fused_uconv_block``); 'kernel' only.

    tp_mesh: a ``parallel.Mesh`` (every rank of it calls with the same
    global batch): each data index runs its rows, every block's channels
    split over its model group (compute tensor parallelism, 'fma' only), and
    every rank returns the whole batch.
    """
    with tracing.span("forward", rows=input_wav.shape[0]):
        if impl is None:
            impl = "kernel" if input_wav.is_cuda and tp_mesh is None else "fma"
        if impl not in _BLOCKS:
            raise ValueError(f"impl {impl!r} not in {sorted(_BLOCKS)}")
        block = _block_fn(impl, pyramid_dtype)
        if tp_mesh is not None:
            if impl != "fma":
                raise ValueError("tp_mesh requires impl='fma'")
            from sudo_rm_rf_tpu_torch.parallel import shard_batch
            from sudo_rm_rf_tpu_torch.parallel.collectives import all_gather_rows

            block = functools.partial(uconv_block_fma, tp_group=tp_mesh.model_group)
            input_wav = shard_batch(tp_mesh, input_wav)
        with tracing.span("forward.encode"):
            model = cast_model(model, compute_dtype, impl)
            x, s, in_len = _encode(model, input_wav, _dtype(compute_dtype))
        for blk in model.sm:
            with tracing.span("forward.block"):
                x = block(x, params_from_module(blk), model.upsampling_depth)
        with tracing.span("forward.decode"):
            est = _decode(model, x, s, in_len, model.num_sources)
        return est if tp_mesh is None else all_gather_rows(est, tp_mesh.data_group)


@torch.no_grad()
def groupcomm_forward_fast(model, input_wav: torch.Tensor, impl: str = None,
                           compute_dtype=None, pyramid_dtype=torch.float32) -> torch.Tensor:
    """model: a ``GroupCommSuDORMRF``; input_wav: (B, C_audio, T) or (B, T)
    fp32. Returns (B, S*C_audio, T) fp32. compute_dtype and pyramid_dtype:
    as :func:`improved_forward_fast`'s.

    Each block is TAC (:func:`_tac_fast`) and then the shared U-ConvBlock
    in the form ``impl`` names, one a role:

    * 'kernel' (the default on a CUDA tensor): TAC by the hand-written
      kernel (``ops.tac.fused_tac``) where the stream is fp32 and a group
      at most ``TAC_MAX_N`` channels wide, else the bandwidth-shaped plain
      TAC; the CUDA U-ConvBlock kernel on the group-folded (B*G, C/G, T)
      layout, whose per-row GlobLN is then per (batch, group);
    * 'fma_merged' (the default on the CPU, and the trainable block's
      form): groups merged into the channel axis
      (:func:`gc_uconv_block_fma_merged`);
    * 'xla': ``uconv_block_reference`` on the folded layout.

    Departure: JAX's 'fma_bd', each shared per-group projection as one
    block-diagonal product, is a TPU layout for the MXU, and the port serves
    its arithmetic as 'fma_merged'; JAX's 'fma', the multiply-add block on
    the folded layout, is served by neither (``uconv_block_fma`` stays the
    Improved model's).
    """
    with tracing.span("forward", rows=input_wav.shape[0]):
        if impl is None:
            impl = "kernel" if input_wav.is_cuda else "fma_merged"
        if impl not in GC_IMPLS:
            raise ValueError(f"impl {impl!r} not in {GC_IMPLS}")
        block = _block_fn(impl, pyramid_dtype)
        with tracing.span("forward.encode"):
            model = cast_model(model, compute_dtype, impl)
            x, s, in_len = _encode(model, input_wav, _dtype(compute_dtype))
        b, c, t = x.shape
        g, depth = model.group_size, model.upsampling_depth
        for blk in model.sm:
            # the hand-written TAC takes an fp32 stream of groups up to
            # TAC_MAX_N channels wide; a bf16 stream (the first block's under
            # compute_dtype) or wider groups run the plain TAC
            fused = impl == "kernel" and x.dtype == torch.float32 and c // g <= TAC_MAX_N
            with tracing.span("forward.tac", fused=int(fused)):
                y = _tac_fast(blk.TAC, x.reshape(b, g, c // g, t), fused=fused)
            with tracing.span("forward.block"):
                kp = params_from_module(blk.UBlock)
                if block is None:
                    x = gc_uconv_block_fma_merged(y.reshape(b, c, t), kp, depth, g)
                else:
                    x = block(y.reshape(b * g, c // g, t), kp, depth).reshape(b, c, t)
        with tracing.span("forward.decode"):
            return _decode(model, x, s, in_len, model.num_sources * model.in_audio_channels)
