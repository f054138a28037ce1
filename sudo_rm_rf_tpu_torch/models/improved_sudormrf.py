"""Improved SuDoRM-RF (the "relu" variant), counterpart of
``sudo_rm_rf_tpu/models/improved_sudormrf.py``.

  * encoder: bias-free Conv1d(1 -> N, k=L, stride=L//2, pad=L//2), xavier init
  * GlobLN + 1x1 bottleneck N -> C
  * num_blocks x U-ConvBlock
  * mask head: PReLU -> 1x1 conv C -> S*N, reshape, ReLU, multiply with the
    *pre-norm* encoder features
  * decoder: ConvTranspose1d(S*N -> S, k=L, stride=L//2, pad=L//2,
    output_padding=L//2-1), bias-free, xavier init
  * pad input length to a multiple of (L//2 * 2**depth), crop output back
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from sudo_rm_rf_tpu_torch import ops
from sudo_rm_rf_tpu_torch.models.layers import (
    Conv1d,
    ConvNormAct,
    ConvTranspose1d,
    DilatedConvNorm,
    GlobLN,
    NormAct,
    PReLU,
    default_generator,
    xavier_uniform_conv,
)
from sudo_rm_rf_tpu_torch.ops.uconv import (
    fused_uconv_block,
    params_from_module,
    uconv_block_fma,
)

BLOCK_IMPLS = ("xla", "fma", "kernel")


def check_tp_mesh(tp_mesh, block_impl: str) -> None:
    """Compute tensor parallelism runs the 'fma' blocks only (JAX's error)."""
    if tp_mesh is not None and block_impl != "fma":
        raise ValueError("tp_mesh requires block_impl='fma'")


def run_blocks(blocks: nn.Sequential, x, remat: bool = False):
    """``blocks(x)``; with ``remat`` each block under
    ``torch.utils.checkpoint`` (non-reentrant), so the backward recomputes
    its activations instead of keeping them, as JAX's ``nn.remat`` does.
    The recompute takes each block's params as the forward saw them (under
    ``torch.func.functional_call``, e.g. the trainer's bf16 casts, not the
    module's own fp32 params). Without autograd there is nothing to keep,
    and the blocks run plainly."""
    if not remat or not torch.is_grad_enabled():
        return blocks(x)
    for block in blocks:
        params = dict(block.named_parameters())
        x = checkpoint(lambda x_, p, b=block: torch.func.functional_call(b, p, (x_,)), x,
                       params, use_reentrant=False)
    return x


class UConvBlock(nn.Module):
    """Successive downsampling/upsampling multi-resolution block.

    1x1 proj C->Cin, a depthwise ladder of `depth` levels (level 0 stride 1,
    k=5; levels 1.. stride 2, k=5), then a reverse pass adding nearest-x2
    upsampled deeper levels into shallower ones, GlobLN+PReLU, and a 1x1 conv
    back to C with a residual.

    block_impl: 'xla' (the plain layers), 'fma' (``ops.uconv.uconv_block_fma``)
    or 'kernel' (``ops.uconv.fused_uconv_block``: the CUDA kernel on a CUDA
    tensor, forward only).

    tp_mesh: a ``parallel.Mesh``: compute tensor parallelism over its model
    group (``uconv_block_fma``'s ``tp_group``); 'fma' only.
    """

    def __init__(self, out_channels: int = 128, in_channels: int = 512,
                 upsampling_depth: int = 4, block_impl: str = "xla", *,
                 tp_mesh=None, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if block_impl not in BLOCK_IMPLS:
            raise ValueError(f"block_impl {block_impl!r} not in {BLOCK_IMPLS}")
        check_tp_mesh(tp_mesh, block_impl)
        g = default_generator(generator)
        self.depth = upsampling_depth
        self.block_impl = block_impl
        self.tp_mesh = tp_mesh
        self.proj_1x1 = ConvNormAct(out_channels, in_channels, 1,
                                    generator=g, device=device)
        self.spp_dw = nn.ModuleList(
            DilatedConvNorm(in_channels, in_channels, kernel_size=5,
                            stride=1 if k == 0 else 2, groups=in_channels,
                            generator=g, device=device)
            for k in range(upsampling_depth)
        )
        self.final_norm = NormAct(in_channels, device=device)
        self.res_conv = Conv1d(in_channels, out_channels, 1, generator=g,
                               device=device)

    def forward(self, x):
        if self.block_impl == "fma":
            return uconv_block_fma(x, params_from_module(self), self.depth,
                                   tp_group=None if self.tp_mesh is None
                                   else self.tp_mesh.model_group)
        if self.block_impl == "kernel":
            return fused_uconv_block(x, params_from_module(self), self.depth)
        residual = x
        cur = self.spp_dw[0](self.proj_1x1(x))
        pyramid = [cur]
        for k in range(1, self.depth):
            cur = self.spp_dw[k](cur)
            pyramid.append(cur)
        acc = pyramid[-1]
        for k in range(self.depth - 2, -1, -1):
            acc = pyramid[k] + ops.upsample_nearest_2x(acc)
        return self.res_conv(self.final_norm(acc)) + residual


class SuDORMRFImproved(nn.Module):
    """Improved SuDoRM-RF separator. Input (B, 1, T) mixture, output (B, S, T).

    remat_blocks: recompute each block's activations in the backward
    (``run_blocks``): about one more forward for O(num_blocks) less memory.

    tp_mesh: a ``parallel.Mesh`` whose model group splits every block's Ci
    channels (compute tensor parallelism, JAX's ``tp_mesh``); requires
    block_impl='fma'. Each rank runs its own rows of a batch.
    """

    def __init__(self, out_channels: int = 128, in_channels: int = 512,
                 num_blocks: int = 16, upsampling_depth: int = 4,
                 enc_kernel_size: int = 21, enc_num_basis: int = 512,
                 num_sources: int = 2, block_impl: str = "xla",
                 remat_blocks: bool = False, *, tp_mesh=None,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        check_tp_mesh(tp_mesh, block_impl)
        g = default_generator(generator)
        self.remat_blocks = remat_blocks
        self.out_channels, self.in_channels = out_channels, in_channels
        self.num_blocks, self.upsampling_depth = num_blocks, upsampling_depth
        self.enc_kernel_size, self.enc_num_basis = enc_kernel_size, enc_num_basis
        self.num_sources = num_sources
        half = enc_kernel_size // 2
        self.encoder = Conv1d(1, enc_num_basis, enc_kernel_size, stride=half,
                              padding=half, use_bias=False,
                              weight_init=xavier_uniform_conv, generator=g,
                              device=device)
        self.ln = GlobLN(enc_num_basis, device=device)
        self.bottleneck = Conv1d(enc_num_basis, out_channels, 1, generator=g,
                                 device=device)
        self.sm = nn.Sequential(*(
            UConvBlock(out_channels, in_channels, upsampling_depth, block_impl,
                       tp_mesh=tp_mesh, generator=g, device=device)
            for _ in range(num_blocks)
        ))
        self.mask_net = nn.Sequential(
            PReLU(device=device),
            Conv1d(out_channels, num_sources * enc_num_basis, 1, generator=g,
                   device=device),
        )
        self.decoder = ConvTranspose1d(
            enc_num_basis * num_sources, num_sources, enc_kernel_size,
            stride=half, padding=half, output_padding=half - 1, generator=g,
            device=device)

    @property
    def n_least_samples_req(self) -> int:
        return (self.enc_kernel_size // 2) * 2**self.upsampling_depth

    def forward(self, input_wav):
        if input_wav.ndim == 2:  # allow (B, T)
            input_wav = input_wav[:, None, :]
        in_len = input_wav.shape[-1]
        x = ops.pad_to_multiple(input_wav, self.n_least_samples_req)
        x = self.encoder(x)
        s = x  # pre-norm encoder features, reused at the mask product
        x = run_blocks(self.sm, self.bottleneck(self.ln(x)), self.remat_blocks)
        x = self.mask_net(x)
        b = x.shape[0]
        x = torch.relu(x.reshape(b, self.num_sources, self.enc_num_basis, -1))
        x = x * s[:, None, :, :]
        est = self.decoder(x.reshape(b, self.num_sources * self.enc_num_basis, -1))
        return ops.unpad_to_length(est, in_len)
