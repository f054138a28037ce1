"""Operations of the causal SuDoRM-RF v3 forward over a (B, C_audio, W)
window, in closed form from the configuration's shapes, counted as
``flops.py`` counts the Improved one: products and convolutions (2 flops a
multiply-add), depthwise as depthwise, every conv at its full kernel (the
masked taps multiply zeros, and are work the forward does), elementwise
work (the masks, PReLUs, the upsample-sums, the skip-init gains) left out.

``tests/test_perfbench_causal.py`` holds the count to ``FlopCounterMode``
over ``reference/causal.py`` on the meta device.
"""

from __future__ import annotations

from perfbench import flops

DW_KERNEL = 21  # every level's depthwise conv, whatever the encoder's kernel


def block_flops(b: int, co: int, ci: int, t: int, depth: int) -> int:
    """One causal U-ConvBlock at (B, Co, Ci, T', depth): the proj and res
    1x1 products and the depthwise k=21 convs, level j at T' / 2**j."""
    return 2 * 2 * b * ci * co * t + 2 * DW_KERNEL * b * ci * sum(t >> j for j in range(depth))


def forward_flops(model: dict, batch: int, n_samples: int) -> int:
    """One forward of a (batch, C_audio, n_samples) window: the encoder
    (kernel 2L-1), bottleneck, the blocks, the mask conv and the
    transposed-conv decoder."""
    t = flops.frames(model, n_samples)
    n, c, ci = model["enc_num_basis"], model["out_channels"], model["in_channels"]
    ca, k = model["in_audio_channels"], model["enc_kernel_size"]
    s = model["num_sources"] * ca
    blk = block_flops(batch, c, ci, t, model["upsampling_depth"])
    return int(2 * batch * t * (n * ca * (2 * k - 1) + n * c + c * s * n + s * n * s * k)
               + model["num_blocks"] * blk)
