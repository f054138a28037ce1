"""Serving forward of the Improved SuDoRM-RF (counterpart of
``sudo_rm_rf_tpu/models/fast_inference.py::improved_forward_fast``).

Same math as ``SuDORMRFImproved.forward``, with every 1x1 conv as an explicit
channel matmul and each U-ConvBlock run by the form ``impl`` names. Forward
only, fp32.
"""

from __future__ import annotations

import torch

from sudo_rm_rf_tpu_torch import ops
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

    for blk in model.sm:
        x = block(x, params_from_module(blk), model.upsampling_depth)

    prelu, mask_conv = model.mask_net
    x = torch.where(x >= 0, x, prelu.weight[0] * x)
    x = torch.matmul(mask_conv.weight[:, :, 0], x) + mask_conv.bias[None, :, None]
    b = x.shape[0]
    x = torch.relu(x.reshape(b, model.num_sources, model.enc_num_basis, -1))
    x = x * s[:, None, :, :]

    est = ops.conv_transpose1d(
        x.reshape(b, model.num_sources * model.enc_num_basis, -1),
        model.decoder.weight, stride=half, padding=half,
        output_padding=half - 1,
    )
    return ops.unpad_to_length(est, in_len)
