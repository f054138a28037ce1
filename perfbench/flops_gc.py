"""Operations of the GroupComm SuDoRM-RF v2 forward, in closed form from the
configuration's shapes, counted as ``flops.py`` counts the Improved one:
products and convolutions (2 flops a multiply-add), depthwise as
depthwise, elementwise work and the mean over the groups left out.

TAC is counted in the published concatenate form (its output Linear over
2h channels on every group), so the count is the model's work however the
program computes it. ``tests/test_perfbench_gc.py`` holds the count to
``FlopCounterMode`` over ``reference/groupcomm.py`` on the meta device.
"""

from __future__ import annotations

from perfbench import flops


def tac_flops(b: int, g: int, n: int, t: int) -> int:
    """One TAC over (B, G, n, T') with hidden h = 3n: the Linear n -> h on
    every group, h -> h on the mean, 2h -> n on every group."""
    h = 3 * n
    return 2 * b * t * (g * n * h + h * h + g * 2 * h * n)


def forward_flops(model: dict, batch: int, n_samples: int) -> int:
    """One forward of a (batch, C_audio, n_samples) mixture: encoder,
    bottleneck, the blocks (TAC and the folded U-ConvBlock), the mask conv
    and the transposed-conv decoder."""
    t = flops.frames(model, n_samples)
    n, c, ci = model["enc_num_basis"], model["out_channels"], model["in_channels"]
    ca, k, g = model["in_audio_channels"], model["enc_kernel_size"], model["group_size"]
    s = model["num_sources"] * ca
    blk = flops.block_flops(batch * g, c // g, ci // g, t, model["upsampling_depth"])
    per_block = tac_flops(batch, g, c // g, t) + blk["gemm"] + blk["ladder"]
    return int(2 * batch * t * (n * ca * k + n * c + c * s * n + s * n * s * k)
               + model["num_blocks"] * per_block)
